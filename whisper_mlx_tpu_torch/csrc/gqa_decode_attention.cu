// Grouped-query attention over the quantized LLM KV cache for Hopper
// (sm_90a): kernel K3's GQA mode.
//
// Replaces: whisper_mlx_tpu/models/qwen.py:289-300, the reference's grouped
// path over an int8 / int4 cache (XLA on the TPU, no Pallas kernel), with
// per-row positions (continuous batching, qwen.py:182-189) and blocks of
// several query positions past 0 (speculative decoding's verify and draft
// sync).
//
// Layout (position-major, models/qwen.py:init_kv_cache):
//   q      (B, KV * rep, Tq, hd) fp32, rotated and normed, not pre-scaled
//   codes  (B, KV, T_alloc, hd) int8, or (B, KV, T_alloc, hd / 2) uint8
//          holding two signed int4 nibbles a byte (low nibble = even d)
//   scales (B, KV, T_alloc) bf16
//   pos    (B,) int32 on the device
// Query head h reads KV head h / rep. Row b's query i attends keys
// t <= pos[b] + i and t < live:
//   s_t = (q . k_t) * (ks_t * scale) in fp32; w = softmax(s);
//   out = sum_t (w_t vs_t) v_t in fp32 -> fp32 or bf16
//
// What bounds it on the H100: device-memory bytes. A decode step reads each
// live code once: Qwen3-32B's 8 KV heads x 128 dims, K and V, int8 (int4)
// plus a bf16 scale each, 4,128 (2,080) B a position a layer; the rep x Tq
// query rows (8 in a decode step) make 2 x 8 operations a code, below the
// card's operations-per-byte balance even in fp32.
//
// Design: one thread-block cluster per (batch row, KV head), so the rep x Tq
// query rows that read a KV head share every tile of its codes, read from
// device memory once. The cluster's C blocks (1 to 8, one per 256 live keys
// of the longest row) split the row's own live keys [0, min(pos[b] + Tq,
// live)) evenly. A block walks its keys in tiles of 64, double-buffered
// through cp.async (16-byte pieces of the codes; the scales as the
// 16-byte-aligned window around the tile, plain loads past the tensor's last
// 16-byte boundary). Per tile, in fp32 on the CUDA cores (the queries stay
// fp32, as in the reference's product):
//   QK: a thread per (key, group of rows) makes its key's codes floats once
//       (a byte permute into the float 2^23 + u, one subtract: exact) and
//       dots them with its rows;
//   an online softmax, a warp a row: running max and sum, the weights
//       exp(s - max) * vs_t kept for PV, the earlier tiles' output rescaled;
//   PV: each warp a group of 8 rows and a share of the tile's keys, a lane
//       hd / 32 dims, in registers across tiles.
// At the end the warps' outputs are summed in warp order; each block pushes
// its row maxima and sums into every block of the cluster (distributed
// shared memory; the first push waits on the cluster barrier every block
// arrived on at its start), and after a cluster barrier combines them in
// block order, scales its output rows by exp(m_own - m) / l and pushes each
// element to the block that owns it; after a second barrier each owner sums
// its elements in block order and writes. No atomics: a repeat is
// bit-equal. More than 64 query rows (rep x Tq: 128 at rep 8, Tq 16) take a
// second pass over the keys.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "sm90_async.cuh"

namespace {

using namespace wmt_async;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TK = 64;                        // keys a tile
constexpr int QK_GROUPS = THREADS / TK;       // QK's row groups: a thread a (key, group)
constexpr int RMAX = 64;                      // query rows a pass
constexpr int PV_ROWS = 8;                    // rows a PV warp holds
constexpr int MAX_CLUSTER = 8;                // the portable cluster size
constexpr int SPLIT = 256;                    // live keys a block of the cluster
constexpr int MAX_TQ = 16;
constexpr int MAX_T = 32768;
constexpr unsigned FULL = 0xffffffffu;

struct Layout {
  int q, k, v, ks, vs, s, red, pout, stat, row, lim, total;
};

__host__ __device__ inline int take(int& off, int bytes) {
  const int at = off;
  off += (bytes + 15) & ~15;
  return at;
}

// Byte offsets into dynamic shared memory for head dim hd, code width bits
// and rp query rows a pass (8, 16 or 64).
__host__ __device__ inline Layout layout(int hd, int bits, int rp) {
  const int krow = hd * bits / 8 + 16;  // a key's codes, padded by 16 bytes
  Layout l;
  int off = 0;
  l.q = take(off, rp * hd * 4);                          // the pass's query rows
  l.k = take(off, 2 * TK * krow);                        // two stages of K codes
  l.v = take(off, 2 * TK * krow);                        // and of V codes
  l.ks = take(off, 2 * (TK + 16) * 2);                   // their scales' windows
  l.vs = take(off, 2 * (TK + 16) * 2);
  l.s = take(off, rp * TK * 4);                          // scores, then w * vs
  l.red = take(off, WARPS * PV_ROWS * hd * 4);           // the warps' outputs
  l.pout = take(off, (rp * hd + MAX_CLUSTER) * 4);       // outputs pushed to this block
  l.stat = take(off, MAX_CLUSTER * rp * 2 * 4);          // every block's (max, sum)
  l.row = take(off, 4 * rp * 4);                         // max, sum, correction, share
  l.lim = take(off, rp * 4);                             // each row's last key + 1
  l.total = off;
  return l;
}

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

// The codes of a 32-bit word as floats, exact: the byte u = code + offset
// becomes the float 2^23 + u (exponent byte 0x4B above it, by a byte
// permute), and one subtract takes away 2^23 and the offset.
template <int BITS>
__device__ __forceinline__ void word_codes(uint32_t w, float* f) {
  if constexpr (BITS == 8) {  // 4 codes: byte i is dim i
    const uint32_t x = w ^ 0x80808080u;  // u = code + 128
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[i] = __int_as_float((int)__byte_perm(x, 0x4Bu, 0x4550u + i)) - 8388736.f;
    }
  } else {  // 8 codes: byte i holds dims 2i (low nibble) and 2i + 1
    const uint32_t x = w ^ 0x88888888u;  // u = code + 8
    const uint32_t lo = x & 0x0F0F0F0Fu;
    const uint32_t hi = (x >> 4) & 0x0F0F0F0Fu;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __int_as_float((int)__byte_perm(lo, 0x4Bu, 0x4550u + i)) - 8388616.f;
      f[2 * i + 1] = __int_as_float((int)__byte_perm(hi, 0x4Bu, 0x4550u + i)) - 8388616.f;
    }
  }
}

// RP query rows a pass (8, 16 or 64; the launcher takes the smallest that
// holds rep x Tq): every loop over rows has a fixed count, since a row loop
// predicated on the live rows issues the instructions of the dead ones too
template <int HD, int BITS, int RP>
__global__ void __launch_bounds__(THREADS)
gqa_attn_kernel(const float* __restrict__ q, const uint8_t* __restrict__ k,
                const __nv_bfloat16* __restrict__ ks, const uint8_t* __restrict__ v,
                const __nv_bfloat16* __restrict__ vs, const int* __restrict__ pos,
                void* __restrict__ out, int n_kv, int rep, int tq, int t_alloc, int live,
                float scale, int out_bf16, long long scale_count) {
  constexpr int rp = RP;
  constexpr int QK_ROWS = RP / QK_GROUPS;  // rows a QK thread holds
  constexpr int NRG = RP / PV_ROWS;        // PV's row groups (1, 2 or 8) ...
  constexpr int NKG = WARPS / NRG;         // ... and key groups
  constexpr int ROWB = HD * BITS / 8;   // bytes of a key's codes
  constexpr int KROW = ROWB + 16;       // a key's row in shared memory (no bank conflicts
                                        // when a warp's lanes read 16 bytes of 32 keys)
  constexpr int CHUNKS = ROWB / 16;     // 16-byte pieces of a key's codes
  constexpr int CPW = 32 / BITS;        // codes a 32-bit word
  constexpr int DPT = HD / 32;          // dims a lane holds in PV
  constexpr int PVB = DPT * BITS / 8;   // bytes of those dims' codes
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay = layout(HD, BITS, rp);
  float* sq = reinterpret_cast<float*>(smem + lay.q);
  uint8_t* sk = smem + lay.k;
  uint8_t* sv = smem + lay.v;
  __nv_bfloat16* sks = reinterpret_cast<__nv_bfloat16*>(smem + lay.ks);
  __nv_bfloat16* svs = reinterpret_cast<__nv_bfloat16*>(smem + lay.vs);
  float* ss = reinterpret_cast<float*>(smem + lay.s);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  float* pout = reinterpret_cast<float*>(smem + lay.pout);
  float* stat = reinterpret_cast<float*>(smem + lay.stat);
  float* rowm = reinterpret_cast<float*>(smem + lay.row);  // running max of each row
  float* rowl = rowm + rp;                                 // running sum of exp(s - max)
  float* rowc = rowl + rp;                                 // this tile's correction
  float* rowf = rowc + rp;                                 // the block's share, exp(m_own - m) / l
  int* rowlim = reinterpret_cast<int*>(smem + lay.lim);    // each row's keys: t < rowlim

  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rows = rep * tq;  // the KV head's query rows: rep heads x tq steps
  const int p0 = max(pos[b], 0);
  // this row's live keys, split evenly over the cluster; key 0 is live for
  // every query, and it lies in block 0
  const int row_live = min(p0 + tq, live);
  const int t0 = rank * row_live / csize;  // < 8 x 32,768: no overflow
  const int t1 = (rank + 1) * row_live / csize;
  const int ntiles = (t1 - t0 + TK - 1) / TK;
  const long long kv = (long long)b * n_kv + g;
  const uint8_t* kb = k + kv * t_alloc * ROWB;
  const uint8_t* vb = v + kv * t_alloc * ROWB;
  const long long sbase = kv * t_alloc;
  const long long tail = scale_count & ~7LL;  // past it no whole 16-byte piece of scales
  const long long qbase = (kv * rep) * tq * HD;  // the KV head's first query row

  // tile j's codes and scales into stage st
  auto issue = [&](int j, int st) {
    const int ta = t0 + j * TK;
    const int cnt = min(TK, t1 - ta);
    uint8_t* dk = sk + st * TK * KROW;
    uint8_t* dv = sv + st * TK * KROW;
    for (int c = tid; c < cnt * CHUNKS; c += THREADS) {
      const int key = c / CHUNKS;
      const int part = c % CHUNKS;
      const long long src = (long long)(ta + key) * ROWB + part * 16;
      cp_async16(dk + key * KROW + part * 16, kb + src, true);
      cp_async16(dv + key * KROW + part * 16, vb + src, true);
    }
    const long long first = sbase + ta;
    const long long sa = first & ~7LL;
    const long long se = min((first + cnt + 7) & ~7LL, tail);
    __nv_bfloat16* dks = sks + st * (TK + 16);
    __nv_bfloat16* dvs = svs + st * (TK + 16);
    for (long long c = tid; sa + 8 * c < se; c += THREADS) {
      cp_async16(dks + 8 * c, ks + sa + 8 * c, true);
      cp_async16(dvs + 8 * c, vs + sa + 8 * c, true);
    }
    for (long long e = max(first, tail) + tid; e < first + cnt; e += THREADS) {
      dks[e - sa] = ks[e];
      dvs[e - sa] = vs[e];
    }
  };

  cluster_arrive_relaxed();  // waited before the first write into another block
  const int prg = warp % NRG;
  const int pkg = warp / NRG;
  for (int r0 = 0; r0 < n_rows; r0 += rp) {
    const int nr = min(rp, n_rows - r0);
    // the pass's rows, zeros past the last (their scores are never kept)
    for (int e = tid; e < rp * HD; e += THREADS) {
      sq[e] = e < nr * HD ? q[qbase + (long long)r0 * HD + e] : 0.f;
    }
    for (int r = tid; r < rp; r += THREADS) {
      rowm[r] = -INFINITY;
      rowl[r] = 0.f;
      // query row r0 + r is head (r0 + r) / tq's step (r0 + r) % tq
      rowlim[r] = min(p0 + (r0 + r) % tq + 1, live);
    }
    float acc[PV_ROWS][DPT];
#pragma unroll
    for (int jj = 0; jj < PV_ROWS; ++jj) {
#pragma unroll
      for (int x = 0; x < DPT; ++x) acc[jj][x] = 0.f;
    }
    if (ntiles > 0) issue(0, 0);
    cp_async_commit();
    for (int j = 0; j < ntiles; ++j) {
      if (j + 1 < ntiles) issue(j + 1, (j + 1) & 1);
      cp_async_commit();
      cp_async_wait(1);  // tile j has landed (this thread's pieces)
      __syncthreads();   // and every thread's
      const int st = j & 1;
      const int ta = t0 + j * TK;
      const int cnt = min(TK, t1 - ta);
      const int soff = (int)((sbase + ta) & 7);
      const __nv_bfloat16* cks = sks + st * (TK + 16) + soff;
      const __nv_bfloat16* cvs = svs + st * (TK + 16) + soff;

      // QK: thread (key t, row group rg) over rows rg, rg + 4, ...; the
      // warp's 32 keys read 16 bytes each a step, its rows' queries are
      // broadcast. Past cnt the stage holds no key: the score is -inf.
      {
        const int t = tid % TK;
        const int rg = tid / TK;
        float sacc[QK_ROWS];
#pragma unroll
        for (int jj = 0; jj < QK_ROWS; ++jj) sacc[jj] = 0.f;
        if (t < cnt) {
          const uint8_t* kr = sk + st * TK * KROW + t * KROW;
#pragma unroll 1
          for (int c = 0; c < CHUNKS; ++c) {
            const uint4 u = *reinterpret_cast<const uint4*>(kr + c * 16);
            const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float kf[CPW];
              word_codes<BITS>(w4[i], kf);
              const int d0 = (c * 4 + i) * CPW;
#pragma unroll
              for (int jj = 0; jj < QK_ROWS; ++jj) {
                const float* qr = sq + (rg + QK_GROUPS * jj) * HD + d0;
#pragma unroll
                for (int x = 0; x < CPW; x += 4) {
                  const float4 qv = *reinterpret_cast<const float4*>(qr + x);
                  sacc[jj] = fmaf(qv.x, kf[x], sacc[jj]);
                  sacc[jj] = fmaf(qv.y, kf[x + 1], sacc[jj]);
                  sacc[jj] = fmaf(qv.z, kf[x + 2], sacc[jj]);
                  sacc[jj] = fmaf(qv.w, kf[x + 3], sacc[jj]);
                }
              }
            }
          }
        }
        const float kscale = t < cnt ? __bfloat162float(cks[t]) * scale : 0.f;
#pragma unroll
        for (int jj = 0; jj < QK_ROWS; ++jj) {
          const int r = rg + QK_GROUPS * jj;
          // rows past the pass's last score -inf: their weights are 0
          ss[r * TK + t] = r < nr && t < cnt && ta + t < rowlim[r] ? sacc[jj] * kscale : -INFINITY;
        }
      }
      __syncthreads();

      // online softmax, a warp a row: exp(s - the running max), its sum, the
      // earlier tiles' correction; the weights times vs for PV (0 past cnt,
      // where the stage holds no scale)
      for (int r = warp; r < rp; r += WARPS) {
        const float s0 = ss[r * TK + lane];
        const float s1 = ss[r * TK + lane + 32];
        const float mold = rowm[r];
        const float mnew = fmaxf(mold, warp_max(fmaxf(s0, s1)));
        float e0 = 0.f, e1 = 0.f, corr = 1.f;
        if (mnew != -INFINITY) {  // never exp(-inf - -inf)
          e0 = expf(s0 - mnew);
          e1 = expf(s1 - mnew);
          corr = expf(mold - mnew);
        }
        const float sum = warp_sum(e0 + e1);
        ss[r * TK + lane] = lane < cnt ? e0 * __bfloat162float(cvs[lane]) : 0.f;
        ss[r * TK + lane + 32] = lane + 32 < cnt ? e1 * __bfloat162float(cvs[lane + 32]) : 0.f;
        if (lane == 0) {
          rowm[r] = mnew;
          rowl[r] = rowl[r] * corr + sum;
          rowc[r] = corr;
        }
      }
      __syncthreads();

      // PV: warp (row group prg, key group pkg) over rows 8 prg .. 8 prg + 7
      // and keys pkg, pkg + NKG, ...; lane dims DPT lane .. DPT lane + DPT - 1
      {
#pragma unroll
        for (int jj = 0; jj < PV_ROWS; ++jj) {
          const float c = rowc[prg * PV_ROWS + jj];
#pragma unroll
          for (int x = 0; x < DPT; ++x) acc[jj][x] *= c;
        }
        const uint8_t* vr = sv + st * TK * KROW + lane * PVB;
        for (int t = pkg; t < cnt; t += NKG) {
          uint32_t w;
          if constexpr (PVB == 4) {
            w = *reinterpret_cast<const uint32_t*>(vr + t * KROW);
          } else if constexpr (PVB == 2) {
            w = *reinterpret_cast<const uint16_t*>(vr + t * KROW);
          } else {
            w = vr[t * KROW];
          }
          float vf[CPW];
          word_codes<BITS>(w, vf);
#pragma unroll
          for (int jj = 0; jj < PV_ROWS; ++jj) {
            const float p = ss[(prg * PV_ROWS + jj) * TK + t];
#pragma unroll
            for (int x = 0; x < DPT; ++x) acc[jj][x] = fmaf(p, vf[x], acc[jj][x]);
          }
        }
      }
      __syncthreads();  // the stage is read: the next issue may refill it
    }
    cp_async_wait(0);

#pragma unroll
    for (int jj = 0; jj < PV_ROWS; ++jj) {
      const int r = prg * PV_ROWS + jj;
#pragma unroll
      for (int x = 0; x < DPT; ++x) red[(pkg * rp + r) * HD + lane * DPT + x] = acc[jj][x];
    }
    __syncthreads();
    if (r0 == 0) cluster_wait();  // every block of the cluster has started
    // every block's (max, sum) of each row, into every block
    for (int e = tid; e < nr * csize; e += THREADS) {
      const int r = e / csize;
      float* dst = cluster.map_shared_rank(stat, e % csize) + (rank * rp + r) * 2;
      dst[0] = rowm[r];
      dst[1] = rowl[r];
    }
    cluster.sync();
    for (int r = tid; r < nr; r += THREADS) {
      float m = -INFINITY;
      for (int src = 0; src < csize; ++src) m = fmaxf(m, stat[(src * rp + r) * 2]);
      float l = 0.f;
      for (int src = 0; src < csize; ++src) {  // block 0 first: a fixed order
        const float ls = stat[(src * rp + r) * 2 + 1];
        if (ls > 0.f) l += ls * expf(stat[(src * rp + r) * 2] - m);
      }
      rowf[r] = rowm[r] != -INFINITY ? expf(rowm[r] - m) / l : 0.f;
    }
    __syncthreads();
    // output e = r * HD + d belongs to block e % C: the warps' outputs summed
    // in warp order, scaled by the block's share, pushed to the owner
    const int n_out = nr * HD;
    const int slots = (n_out + csize - 1) / csize;
    for (int e = tid; e < n_out; e += THREADS) {
      const int r = e / HD;
      const int d = e % HD;
      float o = 0.f;
#pragma unroll
      for (int kg = 0; kg < NKG; ++kg) o += red[(kg * rp + r) * HD + d];
      cluster.map_shared_rank(pout, e % csize)[rank * slots + e / csize] = o * rowf[r];
    }
    cluster.sync();
    for (int slot = tid; slot < slots; slot += THREADS) {
      const int e = slot * csize + rank;
      if (e < n_out) {
        float o = 0.f;
        for (int src = 0; src < csize; ++src) o += pout[src * slots + slot];
        const long long at = qbase + (long long)r0 * HD + e;
        if (out_bf16) {
          reinterpret_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16(o);
        } else {
          reinterpret_cast<float*>(out)[at] = o;
        }
      }
    }
  }
}

template <int HD, int BITS, int RP>
cudaError_t launch(dim3 grid, int csize, cudaStream_t s, const void* q, const void* k,
                   const void* ks, const void* v, const void* vs, const void* pos, void* out,
                   int n_kv, int rep, int tq, int t_alloc, int live, float scale, int out_bf16,
                   long long scale_count) {
  return launch_cluster<gqa_attn_kernel<HD, BITS, RP>>(
      grid, THREADS, layout(HD, BITS, RP).total, csize, s, (const float*)q, (const uint8_t*)k,
      (const __nv_bfloat16*)ks, (const uint8_t*)v, (const __nv_bfloat16*)vs, (const int*)pos,
      out, n_kv, rep, tq, t_alloc, live, scale, out_bf16, scale_count);
}

template <int HD, int BITS>
cudaError_t launch_rows(int rp, dim3 grid, int csize, cudaStream_t s, const void* q,
                        const void* k, const void* ks, const void* v, const void* vs,
                        const void* pos, void* out, int n_kv, int rep, int tq, int t_alloc,
                        int live, float scale, int out_bf16, long long scale_count) {
#define WMT_GQA(RP)                                                                         \
  launch<HD, BITS, RP>(grid, csize, s, q, k, ks, v, vs, pos, out, n_kv, rep, tq, t_alloc, \
                       live, scale, out_bf16, scale_count)
  return rp == 8 ? WMT_GQA(8) : rp == 16 ? WMT_GQA(16) : WMT_GQA(64);
#undef WMT_GQA
}

}  // namespace

extern "C" int wmt_gqa_decode_attention(const void* q, const void* k, const void* ks,
                                        const void* v, const void* vs, const void* pos,
                                        void* out, int b, int n_kv, int rep, int tq, int hd,
                                        int t_alloc, int live, int bits, float scale,
                                        int out_bf16, void* stream) {
  if (b < 1 || b > 65535 || n_kv < 1 || n_kv > 65535 || rep < 1 || tq < 1 || tq > MAX_TQ ||
      (hd != 64 && hd != 128) || (bits != 4 && bits != 8) || t_alloc > MAX_T || live < 1 ||
      live > t_alloc) {
    return (int)cudaErrorInvalidValue;
  }
  // the launch plan: the fewest rows a pass that hold rep x Tq (of the three
  // compiled), a block of the cluster per SPLIT live keys of the longest row
  const int rows = std::min(rep * tq, RMAX);
  const int rp = rows <= 8 ? 8 : rows <= 16 ? 16 : RMAX;
  const int csize = std::min(MAX_CLUSTER, (live + SPLIT - 1) / SPLIT);
  const dim3 grid(csize, n_kv, b);
  const long long scale_count = (long long)b * n_kv * t_alloc;
  const cudaStream_t s = (cudaStream_t)stream;
#define WMT_GQA(H, B)                                                                       \
  launch_rows<H, B>(rp, grid, csize, s, q, k, ks, v, vs, pos, out, n_kv, rep, tq, t_alloc, \
                    live, scale, out_bf16, scale_count)
  cudaError_t e;
  if (hd == 128) {
    e = bits == 8 ? WMT_GQA(128, 8) : WMT_GQA(128, 4);
  } else {
    e = bits == 8 ? WMT_GQA(64, 8) : WMT_GQA(64, 4);
  }
#undef WMT_GQA
  if (e == cudaSuccess) e = cudaGetLastError();
  return (int)e;
}
