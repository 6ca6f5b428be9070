// Decode attention over a quantized KV cache for Hopper (sm_90a).
//
// Replaces: whisper_mlx_tpu/ops/decode_attention.py:decode_attention_int8
// (_decode_dma_kernel for Tq=1, _decode_attn_kernel for Tq>1), the same
// function as ops/kv_quant.py:attention_int8_auto and, with a group g > 1,
// attention_int8_grouped. With int_dot it computes the integer-dot function
// of ops/kv_quant.py:attention_int8_mxu / attention_int8_grouped_mxu (XLA on
// the TPU, the beam default).
//
// Cache layout (Hopper-native, position-major within a head):
//   codes  (B, H, T_alloc, 64) int8, or (B, H, T_alloc, 32) uint8 holding two
//          signed int4 nibbles per byte (low nibble = even d, high = odd d)
//   scales (B, H, T_alloc) bf16
// Query row b reads KV row b / group. Per query row i:
//   keys t <= pos + i (causal) and t < valid_len are attended
//   fp mode:   s_t = (q . k_t) * ks_t in fp32; w = softmax(s) in fp32;
//              w_t * vs_t rounded to bf16; out = sum_t (w_t vs_t) v_t in fp32
//              -> bf16
//   int mode:  q re-quantized per row over d (absmax / 127, round half to
//              even, clip +-127); s_t = s32 * qs * ks_t with s32 an s8 x s8 ->
//              s32 dot; w = softmax(s); wv = w * vs re-quantized over all of
//              the row's keys the same way; out = (sum_t w8_t v_t, exact in
//              int32) * ws -> bf16
//
// What bounds it on the H100: device-memory bytes. A decode step reads every
// live cached code once: the int4 cross cache holds K and V codes of 32 B
// each plus a 2 B scale each, 68 B per (row, head, position), 1500 positions
// x 20 heads x 32 layers per row; the dots are 2 operations per code, far
// below the card's operations-per-byte balance in either mode. One layer's
// greedy step (self int8 at 227 keys, cross int4 at 1500, 8 rows) is 21 MB,
// 6.3 us at 3.35 TB/s.
//
// Design: one thread-block cluster per (KV row, head). Its C blocks (1 to 8,
// one per 256 live keys of the longest row, so a self cache that grows key
// by key starts at 1) each take a contiguous slice of the keys, and every
// one of the g x Tq query rows that read the KV row is served by the same
// blocks, so each code leaves device memory once, the bound's own count.
// When a block starts, one thread issues bulk copies (cp.async.bulk, no
// tensor map) of its slice of K codes and K scales on one mbarrier and of V
// codes and V scales on another: V is in flight while QK and the row maxima run.
// Both products run on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// out): the codes become bf16x2 pairs in one mask-and-or and one bf16x2 FMA
// each (int8 as its two nibbles, summed as 16 hi + lo), exact, and the query
// rows (int mode: their int8 codes) and the weights w * vs (int mode: their
// codes) are bf16 already, so every product is exact and, in the integer
// mode, so is every sum (below 2^24): the s8 x s8 -> s32 dots. The softmax
// stays fp32 in SIMT. Each block pushes its row max, its sum of
// exp(s - max) and, in the integer mode, its max of exp(s - max) * vs into
// every block's shared memory (distributed shared memory); after one cluster
// barrier each block combines them in block order into the row's max, sum
// and absmax of w * vs, rounds its own w_t * vs_t as above and runs PV over
// its slice. The partial outputs are pushed to the block that owns each
// output, and after a second barrier each owner sums them in block order
// and writes. Two cluster barriers a pass of up to 8 query rows (one row a
// pass in greedy decode, a smaller block); no atomics: a repeat is
// bit-equal. A block holds at most 256 keys (MAX_T / 8).
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
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_T = 2048;
constexpr int MAX_CLUSTER = 8;                 // the portable cluster size
constexpr int SLICE = MAX_T / MAX_CLUSTER;     // most keys a block holds: the cluster
                                               // grows by one block per SLICE live keys
constexpr int ROWS = 8;                        // query rows of a pass
constexpr unsigned FULL = 0xffffffffu;

template <int BITS, int RP>
struct Smem {
  alignas(16) uint8_t k[SLICE * BITS * HD / 8];
  alignas(16) uint8_t v[SLICE * BITS * HD / 8];
  alignas(16) __nv_bfloat16 ks[SLICE + 16];  // the slice's scales from an aligned start
  alignas(16) __nv_bfloat16 vs[SLICE + 16];
  union {
    float s[RP][SLICE];          // scores, then the block's exp(s - its max)
    float wsum[WARPS][RP][HD];   // then the warps' partial outputs (PV reads wb)
  };
  alignas(16) float q[RP][HD];
  // QK's B: the rows' q (int mode: their int8 codes) as bf16 in the mma's
  // dim order (qpos); PV's B: the weights w * vs (int mode: their codes)
  alignas(16) __nv_bfloat16 qb[RP][HD];
  alignas(16) __nv_bfloat16 wb[RP][SLICE];
  float qscale[RP];
  // pushed here by every block of the cluster: its (max, sum of exp(s - max),
  // int mode: max exp(s - max) vs) of each row, and its partial outputs
  // (int mode: int32 bits) of the outputs this block owns
  float stat[MAX_CLUSTER][RP][3];
  float red[WARPS][RP][2];  // the warps' partial row statistics
  float row[RP][3];         // the cluster's row max, sum and (int mode) w * vs scale
  float pout[RP * HD + MAX_CLUSTER];
  alignas(8) uint64_t bar[2];  // K codes + scales, V codes + scales
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

// Codes to bf16x2 pairs for the mma (quant_tile.cuh's dequant_bf16x2 with
// scale 1): the nibbles at bits 0-3 and 16-19 of x, stored offset by 8
// (int4 codes and int8 high nibbles, after an xor with 0x88888888 or
// 0x80808080) or as they are (int8 low nibbles, 0..15). Exact in bf16.
constexpr uint32_t BF16_ONE2 = 0x3F803F80u;    // (1, 1)
constexpr uint32_t BF16_M136 = 0xC308C308u;    // (-136, -136): 128 + u - 136 = u - 8
constexpr uint32_t BF16_M128 = 0xC300C300u;    // (-128, -128)

__device__ __forceinline__ uint32_t pair_signed(uint32_t x) {
  return dequant_bf16x2(x, BF16_ONE2, BF16_M136);
}

__device__ __forceinline__ uint32_t pair_low(uint32_t x) {
  return dequant_bf16x2(x, BF16_ONE2, BF16_M128);
}

// where dim d of a query row sits in qb: within each 16 dims, the order in
// which a lane's k-steps take the codes (int4: 8 dims of a word as 0, 4, 1, 5,
// 2, 6, 3, 7; int8: 4 dims of a word as 0, 2, 1, 3)
template <int BITS>
__device__ __forceinline__ int qpos(int d) {
  return BITS == 4 ? (d & ~7) | (((d & 3) << 1) | ((d >> 2) & 1))
                   : (d & ~3) | (((d & 1) << 1) | ((d >> 1) & 1));
}

template <int BITS, bool INT_DOT, int RP>
__global__ void __launch_bounds__(THREADS, 8)
decode_attn_kernel(const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ k,
                   const __nv_bfloat16* __restrict__ ks, const uint8_t* __restrict__ v,
                   const __nv_bfloat16* __restrict__ vs, __nv_bfloat16* __restrict__ out,
                   int n_head, int tq, int t_alloc, int group, int pos, int causal,
                   int valid_len, int live, long long scale_count) {
  constexpr int ROWB = BITS * HD / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<BITS, RP>& sm = *reinterpret_cast<Smem<BITS, RP>*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int h = blockIdx.y;
  const int kv_row = blockIdx.z;
  // the block's keys [t0, t0 + cnt): at least one, since C <= live
  const int t0 = (int)((long long)rank * live / csize);
  const int cnt = (int)((long long)(rank + 1) * live / csize) - t0;
  const long long first = ((long long)kv_row * n_head + h) * t_alloc + t0;
  // the slice's scales: one bulk copy of the 16-byte-aligned window around
  // them, and plain loads for any past the tensor's last 16-byte boundary
  const long long sa = first & ~7LL;
  const long long tail = scale_count & ~7LL;
  const long long se = min((first + cnt + 7) & ~7LL, tail);
  const int soff = (int)(first - sa);

  cluster_arrive_relaxed();  // waited before the first push to another block
  if (tid == 0) {
    mbar_init(&sm.bar[0], 1);
    mbar_init(&sm.bar[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    const uint32_t codes = (uint32_t)cnt * ROWB;
    const uint32_t sbytes = se > sa ? (uint32_t)(se - sa) * 2 : 0u;
    mbar_expect_tx(&sm.bar[0], codes + sbytes);
    bulk_load(sm.k, k + first * ROWB, codes, &sm.bar[0]);
    if (sbytes) bulk_load(sm.ks, ks + sa, sbytes, &sm.bar[0]);
    mbar_expect_tx(&sm.bar[1], codes + sbytes);
    bulk_load(sm.v, v + first * ROWB, codes, &sm.bar[1]);
    if (sbytes) bulk_load(sm.vs, vs + sa, sbytes, &sm.bar[1]);
  }
  for (long long e = max(first, tail) + tid; e < first + cnt; e += THREADS) {
    sm.ks[e - sa] = ks[e];
    sm.vs[e - sa] = vs[e];
  }

  const int rows_total = group * tq;
  for (int r0 = 0; r0 < rows_total; r0 += RP) {
    const int nr = min(RP, rows_total - r0);
    // query row r0 + rr: batch row kv_row * group + (r0 + rr) / tq, step (r0 + rr) % tq
    auto q_off = [&](int rr) {
      const int row = r0 + rr;
      return (((size_t)kv_row * group + row / tq) * n_head + h) * tq * HD + (size_t)(row % tq) * HD;
    };
    auto limit = [&](int rr) {
      return causal ? min(pos + (r0 + rr) % tq + 1, valid_len) : valid_len;
    };
    for (int e = tid; e < nr * HD; e += THREADS) {
      const __nv_bfloat16 qv = q[q_off(e / HD) + e % HD];
      sm.q[e / HD][e % HD] = __bfloat162float(qv);
      if constexpr (!INT_DOT) sm.qb[e / HD][qpos<BITS>(e % HD)] = qv;
    }
    __syncthreads();
    if constexpr (INT_DOT) {
      for (int rr = warp; rr < nr; rr += WARPS) {
        const float amax = warp_max(fmaxf(fabsf(sm.q[rr][lane]), fabsf(sm.q[rr][lane + 32])));
        const float qs = fmaxf(amax, 1e-30f) / 127.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // the row's int8 codes, exact in bf16
          const int d = lane + 32 * h;
          sm.qb[rr][qpos<BITS>(d)] = __float2bfloat16(quantize_code(sm.q[rr][d], qs));
        }
        if (lane == 0) sm.qscale[rr] = qs;
      }
      __syncthreads();
    }

    // scores on the tensor cores: S (16 keys x 8 rows) += K (16 keys x 16
    // dims) Q^T, m16n8k16 bf16 -> fp32, warp w taking key tiles w, w + 4, ...
    // Lane (gq, cq) holds A of keys gq and gq + 8 over its 16 dims 16 cq ..
    // 16 cq + 15, their words' nibble (int8: byte) pairs in turn, and B of
    // row gq in the same order (qb). int8 codes go in as their high (signed)
    // and low (unsigned) nibbles, two products summed as 16 hi + lo. Every
    // product is exact; in the integer mode so are the sums (< 2^24), so S
    // is the s8 x s8 -> s32 dot.
    mbar_wait(&sm.bar[0], 0);
    {
      const int gq = lane >> 2;
      const int cq = lane & 3;
      uint32_t bq[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
      if (gq < nr) {
        const uint4* p = reinterpret_cast<const uint4*>(&sm.qb[gq][16 * cq]);
        const uint4 u0 = p[0];
        const uint4 u1 = p[1];
        bq[0] = u0.x, bq[1] = u0.y, bq[2] = u0.z, bq[3] = u0.w;
        bq[4] = u1.x, bq[5] = u1.y, bq[6] = u1.z, bq[7] = u1.w;
      }
      for (int kt = warp; kt * 16 < cnt; kt += WARPS) {
        const uint8_t* r0 = sm.k + (16 * kt + gq) * ROWB;  // key gq of the tile
        const uint8_t* r1 = r0 + 8 * ROWB;                 // key gq + 8
        float sc[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (BITS == 4) {
          const uint2 u0 = *reinterpret_cast<const uint2*>(r0 + 8 * cq);
          const uint2 u1 = *reinterpret_cast<const uint2*>(r1 + 8 * cq);
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
          const uint4 u0 = *reinterpret_cast<const uint4*>(r0 + 16 * cq);
          const uint4 u1 = *reinterpret_cast<const uint4*>(r1 + 16 * cq);
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
        // sc: keys gq (0, 1) and gq + 8 (2, 3) at rows 2 cq, 2 cq + 1
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = 16 * kt + gq + (i >> 1) * 8;
          const int rr = 2 * cq + (i & 1);
          if (rr < nr && t < cnt) {
            const float kscale = __bfloat162float(sm.ks[soff + t]);
            const float sv = INT_DOT ? sc[i] * sm.qscale[rr] * kscale : sc[i] * kscale;
            sm.s[rr][t] = t0 + t < limit(rr) ? sv : -INFINITY;
          }
        }
      }
    }
    __syncthreads();

    // softmax across the cluster. The block's statistics of each row over
    // its keys (every thread over a stride of keys, then the warps in
    // order) are pushed to every block; one cluster barrier; each block
    // combines them in block order. A block may hold no live key of a row:
    // its max is -inf and its sums 0 (never exp(-inf - -inf)); the cluster's
    // max is finite, since key 0 is live for every row and lies in block 0.
    float mx[RP];
#pragma unroll
    for (int rr = 0; rr < RP; ++rr) {
      if (rr < nr) {
        float m = -INFINITY;
        for (int t = tid; t < cnt; t += THREADS) m = fmaxf(m, sm.s[rr][t]);
        m = warp_max(m);
        if (lane == 0) sm.red[warp][rr][0] = m;
      }
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < RP; ++rr) {
      if (rr < nr) {
        mx[rr] = sm.red[0][rr][0];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) mx[rr] = fmaxf(mx[rr], sm.red[w][rr][0]);
      }
    }
    __syncthreads();  // the maxima are read before the sums overwrite them
    // V's codes and scales have landed: the int mode's sums below and both
    // modes' weights w * vs read the V scales (reading them earlier raced
    // the bulk copy, and now and then took stale scales)
    mbar_wait(&sm.bar[1], 0);
#pragma unroll
    for (int rr = 0; rr < RP; ++rr) {
      if (rr < nr) {
        float l = 0.f;
        float a = 0.f;
        for (int t = tid; t < cnt; t += THREADS) {  // the block's exp(s - its max), kept
          const float p = mx[rr] != -INFINITY ? expf(sm.s[rr][t] - mx[rr]) : 0.f;
          sm.s[rr][t] = p;
          l += p;
          if constexpr (INT_DOT) a = fmaxf(a, p * __bfloat162float(sm.vs[soff + t]));
        }
        l = warp_sum(l);
        if constexpr (INT_DOT) a = warp_max(a);
        if (lane == 0) {
          sm.red[warp][rr][0] = l;
          sm.red[warp][rr][1] = a;
        }
      }
    }
    __syncthreads();
    if (r0 == 0) cluster_wait();  // every block of the cluster has started
    if (warp == 0 && lane < csize) {
#pragma unroll
      for (int rr = 0; rr < RP; ++rr) {
        if (rr >= nr) break;
        float l = 0.f;
        float a = 0.f;
        for (int w = 0; w < WARPS; ++w) {
          l += sm.red[w][rr][0];
          a = fmaxf(a, sm.red[w][rr][1]);
        }
        float* dst = cluster.map_shared_rank(&sm.stat[rank][rr][0], lane);
        dst[0] = mx[rr];
        dst[1] = l;
        dst[2] = a;
      }
    }
    cluster.sync();
    if (tid < nr) {
      float m = -INFINITY;
      for (int src = 0; src < csize; ++src) m = fmaxf(m, sm.stat[src][tid][0]);
      float l = 0.f;
      float amax = 0.f;
      for (int src = 0; src < csize; ++src) {  // block 0 first: a fixed order
        if (sm.stat[src][tid][1] > 0.f) {
          const float f = expf(sm.stat[src][tid][0] - m);
          l += sm.stat[src][tid][1] * f;
          amax = fmaxf(amax, sm.stat[src][tid][2] * f);
        }
      }
      // this block's exp(s - its max) to w = exp(s - m) / l: one factor a row
      const float own = sm.stat[rank][tid][0];  // this block's max, pushed to itself too
      sm.row[tid][0] = own != -INFINITY ? expf(own - m) / l : 0.f;
      sm.row[tid][2] = fmaxf(amax / l, 1e-30f) / 127.f;  // int mode: the absmax of w * vs
    }
    __syncthreads();
    for (int t = tid; t < cnt; t += THREADS) {
      const float vscale = __bfloat162float(sm.vs[soff + t]);
#pragma unroll
      for (int rr = 0; rr < RP; ++rr) {
        if (rr < nr) {
          const float wv = sm.s[rr][t] * sm.row[rr][0] * vscale;
          // the weight rounded to bf16 (int mode: its code, exact in bf16)
          sm.wb[rr][t] = __float2bfloat16(INT_DOT ? quantize_code(wv, sm.row[rr][2]) : wv);
        }
      }
    }
    for (int e = tid; e < RP * 16; e += THREADS) {  // zeros to the end of the last key tile
      const int t = cnt + e % 16;
      if (e / 16 < nr && t < (cnt + 15) / 16 * 16) sm.wb[e / 16][t] = __float2bfloat16(0.f);
    }
    __syncthreads();

    // PV on the tensor cores: O^T (16 dims x 8 rows) += V^T (16 dims x 16
    // keys) W^T, warp w taking key tiles w, w + 4, ... Lane (gq, cq) holds A
    // of its dims 8 gq .. 8 gq + 7 (one word of a key row: dim tile T takes
    // dims 8 gq + 2 T and + 1, byte T's two nibbles for int4, bytes 2 T and
    // 2 T + 1 for int8) at keys 2 cq, 2 cq + 1 and 2 cq + 8, 2 cq + 9 of the
    // tile, paired across two key rows by a byte permute, and B of row gq's
    // weights at those keys. Exact products, fp32 sums (exact in the
    // integer mode, < 2^24).
    {
      const int gq = lane >> 2;
      const int cq = lane & 3;
      float acc[4][4];
      float acch[4][4];
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[tt][i] = acch[tt][i] = 0.f;
      }
      for (int kt = warp; kt * 16 < cnt; kt += WARPS) {
        const int kb0 = 16 * kt + 2 * cq;  // keys kb0, kb0 + 1, kb0 + 8, kb0 + 9
        uint32_t b0 = 0u, b1 = 0u;
        if (gq < nr) {
          b0 = *reinterpret_cast<const uint32_t*>(&sm.wb[gq][kb0]);
          b1 = *reinterpret_cast<const uint32_t*>(&sm.wb[gq][kb0 + 8]);
        }
        const int keys[4] = {kb0, kb0 + 1, kb0 + 8, kb0 + 9};
        if constexpr (BITS == 4) {
          uint32_t w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            w[i] = *reinterpret_cast<const uint32_t*>(sm.v + keys[i] * ROWB + 4 * gq) ^ 0x88888888u;
          }
#pragma unroll
          for (int tt = 0; tt < 4; ++tt) {  // byte tt of the word: dims 8 gq + 2 tt, + 1
            const uint32_t sel = (uint32_t)tt | ((uint32_t)(4 + tt) << 8);
            const uint32_t p01 = __byte_perm(w[0], w[1], sel);
            const uint32_t p89 = __byte_perm(w[2], w[3], sel);
            mma_16816(acc[tt], pair_signed(p01), pair_signed(p01 >> 4), pair_signed(p89),
                      pair_signed(p89 >> 4), b0, b1);
          }
        } else {
          uint2 w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint2 u = *reinterpret_cast<const uint2*>(sm.v + keys[i] * ROWB + 8 * gq);
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
            mma_16816(acc[tt], pair_low(pa), pair_low(pb), pair_low(qa), pair_low(qb), b0, b1);
            mma_16816(acch[tt], pair_signed(pa >> 4), pair_signed(pb >> 4), pair_signed(qa >> 4),
                      pair_signed(qb >> 4), b0, b1);
          }
        }
      }
      // acc[tt]: dims 8 gq + 2 tt (0, 1) and + 1 (2, 3) at rows 2 cq, 2 cq + 1
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int rr = 2 * cq + (i & 1);
          if (rr < nr) {
            const float o = BITS == 8 ? fmaf(16.f, acch[tt][i], acc[tt][i]) : acc[tt][i];
            sm.wsum[warp][rr][8 * gq + 2 * tt + (i >> 1)] =
                INT_DOT ? __int_as_float(__float2int_rn(o)) : o;
          }
        }
      }
    }
    __syncthreads();
    // output e = row * HD + d belongs to block e % C: every block pushes its
    // partial into the owner's slots, one cluster barrier, and each owner
    // sums its slots in block order and writes. After the barrier no block
    // reads another's shared memory, so none waits for the others to leave.
    const int slots = (nr * HD + csize - 1) / csize;
    for (int e = tid; e < nr * HD; e += THREADS) {
      const int rr = e / HD;
      const int d = e % HD;
      float o;
      if constexpr (INT_DOT) {
        int io = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) io += __float_as_int(sm.wsum[w][rr][d]);
        o = __int_as_float(io);
      } else {
        o = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) o += sm.wsum[w][rr][d];
      }
      cluster.map_shared_rank(sm.pout, e % csize)[rank * slots + e / csize] = o;
    }
    cluster.sync();
    for (int slot = tid; slot < slots; slot += THREADS) {
      const int e = slot * csize + rank;
      if (e < nr * HD) {
        float o;
        if constexpr (INT_DOT) {
          int io = 0;
          for (int src = 0; src < csize; ++src) io += __float_as_int(sm.pout[src * slots + slot]);
          o = (float)io * sm.row[e / HD][2];
        } else {
          o = 0.f;
          for (int src = 0; src < csize; ++src) o += sm.pout[src * slots + slot];
        }
        out[q_off(e / HD) + e % HD] = __float2bfloat16(o);
      }
    }
  }
}

template <int BITS, bool INT_DOT, int RP>
cudaError_t launch(dim3 grid, int csize, cudaStream_t s, const void* q, const void* k,
                   const void* ks, const void* v, const void* vs, void* out, int n_head, int tq,
                   int t_alloc, int group, int pos, int causal, int valid_len, int live,
                   long long scale_count) {
  return launch_cluster<decode_attn_kernel<BITS, INT_DOT, RP>>(
      grid, THREADS, (int)sizeof(Smem<BITS, RP>), csize, s, (const __nv_bfloat16*)q,
      (const uint8_t*)k, (const __nv_bfloat16*)ks, (const uint8_t*)v, (const __nv_bfloat16*)vs,
      (__nv_bfloat16*)out, n_head, tq, t_alloc, group, pos, causal, valid_len, live, scale_count);
}

}  // namespace

extern "C" int wmt_decode_attention(const void* q, const void* k,
                                    const void* ks, const void* v,
                                    const void* vs, void* out, int bq,
                                    int n_head, int tq, int t_alloc, int group,
                                    int pos, int causal, int valid_len,
                                    int bits, int int_dot, void* stream) {
  if (t_alloc > MAX_T || valid_len < 1 || valid_len > t_alloc || group < 1 || bq < 1 ||
      bq % group || bq / group > 65535 || n_head < 1 || n_head > 65535 || tq < 1 || pos < 0 ||
      (bits != 4 && bits != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  // the longest row's live keys, and a block for every SLICE of them
  const int live = causal ? std::min(pos + tq, valid_len) : valid_len;
  const int csize = (live + SLICE - 1) / SLICE;
  const dim3 grid(csize, n_head, bq / group);
  const long long scale_count = (long long)(bq / group) * n_head * t_alloc;
  const cudaStream_t s = (cudaStream_t)stream;
  // one query row a KV row (greedy decode) takes the small form: one row a pass
#define WMT_DA(B, I)                                                                          \
  (group * tq == 1                                                                              \
       ? launch<B, I, 1>(grid, csize, s, q, k, ks, v, vs, out, n_head, tq, t_alloc, group, pos, \
                         causal, valid_len, live, scale_count)                                  \
       : launch<B, I, ROWS>(grid, csize, s, q, k, ks, v, vs, out, n_head, tq, t_alloc, group,   \
                            pos, causal, valid_len, live, scale_count))
  cudaError_t e;
  if (bits == 8) {
    e = int_dot ? WMT_DA(8, true) : WMT_DA(8, false);
  } else {
    e = int_dot ? WMT_DA(4, true) : WMT_DA(4, false);
  }
#undef WMT_DA
  return (int)e;
}
