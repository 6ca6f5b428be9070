// Non-causal encoder self-attention for Hopper (sm_90a).
//
// Replaces: whisper_mlx_tpu/ops/dense_attention.py:dense_attention
// (_dense_attn_kernel), the Pallas TPU kernel the encoder uses when
// flash_attention=True and Tk <= 2048.
//
// Computes, per (batch*head) row, with q and k pre-scaled by hd^-1/4:
//     s = q . k^T   (bf16 in, fp32 accumulate; keys >= Tk masked)
//     w = softmax(s) in fp32, rounded to bf16
//     out = w . v   (bf16 in, fp32 accumulate) -> bf16
//
// What bounds it on the H100: tensor-core FLOPs and the fp32 softmax. At the
// encoder shape (B*20 heads, T=1500, hd=64) one layer is 4*B*20*1500^2*64
// FLOPs and B*20*1500^2 exponentials; the TPU kernel kept a whole 1500-key
// fp32 score row in VMEM, which does not fit the 227 KB of shared memory a
// block may use (64 rows x 1500 keys x 4 B = 384 KB).
//
// Simple design: one block of 4 warps per (b*h, 64-query tile); each warp
// owns 16 query rows. K and V stream through shared memory in 64-key tiles.
// Two passes over the keys: pass 1 computes each row's max and softmax
// denominator with tensor-core (wmma bf16 -> fp32) scores; pass 2 recomputes
// the scores, forms the normalized weights, rounds them to bf16 exactly as
// the reference does, and accumulates w . v in wmma fp32 accumulators. No
// score matrix reaches device memory. Not yet wgmma/TMA: that is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int HD = 64;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int LDH = HD + 8;  // bf16 row stride in shared memory
constexpr int LDS = BK + 4;  // fp32 score row stride in shared memory
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Smem {
  __nv_bfloat16 q[BQ * LDH];
  __nv_bfloat16 k[BK * LDH];
  __nv_bfloat16 v[BK * LDH];
  float s[WARPS][16 * LDS];
  __nv_bfloat16 p[WARPS][16 * LDH];
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// 64 rows x 64 bf16 from a (rows, 64) row-major matrix; rows past n are 0.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int row0, int n) {
  for (int i = threadIdx.x; i < 64 * 8; i += THREADS) {
    const int r = i >> 3;
    const int c = i & 7;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * HD + c * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * LDH + c * 8) = val;
  }
}

// This warp's 16 x 64 score tile (its query rows x the staged keys).
__device__ __forceinline__ void score_tile(const Smem& sm, float* s_w,
                                           const FragA (&qa)[HD / 16]) {
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      FragBc kb;
      wmma::load_matrix_sync(kb, sm.k + (j * 16) * LDH + kk * 16, LDH);
      wmma::mma_sync(acc, qa[kk], kb, acc);
    }
    wmma::store_matrix_sync(s_w + j * 16, acc, LDS, wmma::mem_row_major);
  }
}

__global__ void __launch_bounds__(THREADS)
dense_attn_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ out, int tq, int tk) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* qb = q + (size_t)bh * tq * HD;
  const __nv_bfloat16* kb = k + (size_t)bh * tk * HD;
  const __nv_bfloat16* vb = v + (size_t)bh * tk * HD;
  float* s_w = sm.s[warp];
  __nv_bfloat16* p_w = sm.p[warp];

  load_tile(sm.q, qb, q0, tq);
  __syncthreads();
  FragA qa[HD / 16];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    wmma::load_matrix_sync(qa[kk], sm.q + (warp * 16) * LDH + kk * 16, LDH);
  }

  // two lanes per query row, 32 key columns each
  const int r = lane >> 1;
  const int half = lane & 1;
  float m_run = NEG;
  float l_run = 0.f;

  // pass 1: row max and softmax denominator
  for (int key0 = 0; key0 < tk; key0 += BK) {
    __syncthreads();
    load_tile(sm.k, kb, key0, tk);
    __syncthreads();
    score_tile(sm, s_w, qa);
    __syncwarp();
    const float* row = s_w + r * LDS + half * 32;
    const int kbase = key0 + half * 32;
    float mt = NEG;
    for (int c = 0; c < 32; ++c) {
      if (kbase + c < tk) mt = fmaxf(mt, row[c]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 1));
    const float m_new = fmaxf(m_run, mt);
    float sum = 0.f;
    for (int c = 0; c < 32; ++c) {
      if (kbase + c < tk) sum += expf(row[c] - m_new);
    }
    sum += __shfl_xor_sync(FULL, sum, 1);
    l_run = l_run * expf(m_run - m_new) + sum;
    m_run = m_new;
    __syncwarp();
  }

  // pass 2: normalized bf16 weights times V
  FragC o[HD / 16];
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) wmma::fill_fragment(o[n], 0.f);
  for (int key0 = 0; key0 < tk; key0 += BK) {
    __syncthreads();
    load_tile(sm.k, kb, key0, tk);
    load_tile(sm.v, vb, key0, tk);
    __syncthreads();
    score_tile(sm, s_w, qa);
    __syncwarp();
    const float* row = s_w + r * LDS + half * 32;
    __nv_bfloat16* prow = p_w + r * LDH + half * 32;
    const int kbase = key0 + half * 32;
    for (int c = 0; c < 32; ++c) {
      const float w = (kbase + c < tk) ? expf(row[c] - m_run) / l_run : 0.f;
      prow[c] = __float2bfloat16(w);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      FragA pa;
      wmma::load_matrix_sync(pa, p_w + kk * 16, LDH);
#pragma unroll
      for (int n = 0; n < HD / 16; ++n) {
        FragBr vf;
        wmma::load_matrix_sync(vf, sm.v + (kk * 16) * LDH + n * 16, LDH);
        wmma::mma_sync(o[n], pa, vf, o[n]);
      }
    }
  }

  __syncwarp();
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) {
    wmma::store_matrix_sync(s_w + n * 16, o[n], LDS, wmma::mem_row_major);
  }
  __syncwarp();
  __nv_bfloat16* ob = out + (size_t)bh * tq * HD;
  for (int i = lane; i < 16 * HD; i += 32) {
    const int rr = i / HD;
    const int c = i - rr * HD;
    const int qrow = q0 + warp * 16 + rr;
    if (qrow < tq) ob[(size_t)qrow * HD + c] = __float2bfloat16(s_w[rr * LDS + c]);
  }
}

}  // namespace

extern "C" int wmt_dense_attention(const void* q, const void* k, const void* v,
                                   void* out, int bh, int tq, int tk,
                                   void* stream) {
  if (bh < 1 || tq < 1 || tk < 1 || bh > 65535) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      dense_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((tq + BQ - 1) / BQ, bh);
  dense_attn_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, tq, tk);
  return (int)cudaGetLastError();
}
