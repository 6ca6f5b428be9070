// Online-softmax (flash) attention for Hopper (sm_90a), causal or not,
// with grouped KV heads.
//
// Replaces: whisper_mlx_tpu/ops/flash_attention.py:flash_attention
// (_flash_kernel), the Pallas TPU kernel of the Qwen prefill (causal) and of
// whisper encoder attention over more than 2048 keys (non-causal).
//
// Computes, per (batch, head) and query row, with q and k pre-scaled by
// hd^-1/4 and KV head = head / (H / KV):
//     s = q . k^T (keys >= Tk, and keys after the row when causal, masked)
//     out = softmax(s) . v, by the online-softmax recurrence in fp32
// The TPU kernel multiplies p . v in fp32; this one rounds p to bf16 for the
// tensor cores (the tolerance against the fp32 plain version says so).
//
// What bounds it on the H100: at the prefill shapes (B = 1, H = 64, hd =
// 128, T <= 4096) it is small work (69 GFLOP causal at T = 2048), so the
// per-block latency and occupancy matter more than the tensor-core peak.
//
// Simple design: one block of 4 warps per (b*h, 64-query tile); each warp
// owns 16 query rows. K and V stream through shared memory in 64-key tiles;
// key tiles wholly after the query tile are skipped when causal. wmma bf16
// -> fp32 computes the scores and p . v; each warp keeps its 16 x hd output
// accumulator in shared memory, so the rescale by exp(m_old - m_new) is a
// plain per-row multiply. Two lanes own each row's softmax statistics.
// Not yet wgmma/TMA or a pipelined K/V ring: that is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int LDS = BK + 4;  // fp32 score row stride
constexpr int LDP = BK + 8;  // bf16 probability row stride
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

template <int HD>
struct Smem {
  static constexpr int LDH = HD + 8;  // bf16 q/k/v row stride
  static constexpr int LDO = HD + 4;  // fp32 output accumulator row stride
  __nv_bfloat16 q[BQ * LDH];
  __nv_bfloat16 k[BK * LDH];
  __nv_bfloat16 v[BK * LDH];
  float s[WARPS][16 * LDS];
  __nv_bfloat16 p[WARPS][16 * LDP];
  float o[WARPS][16 * LDO];
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// 64 rows x HD bf16 from a (rows, HD) row-major matrix; rows past n are 0.
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int n) {
  constexpr int CH = HD / 8;
  for (int i = threadIdx.x; i < 64 * CH; i += THREADS) {
    const int r = i / CH;
    const int c = i % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * HD + c * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * Smem<HD>::LDH + c * 8) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_attn_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                  int h, int kvh, int tq, int tk, int causal) {
  constexpr int LDH = Smem<HD>::LDH;
  constexpr int LDO = Smem<HD>::LDO;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<HD>& sm = *reinterpret_cast<Smem<HD>*>(smem_raw);
  const int bh = blockIdx.y;
  const int kv_row = (bh / h) * kvh + (bh % h) / (h / kvh);
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* qb = q + (size_t)bh * tq * HD;
  const __nv_bfloat16* kb = k + (size_t)kv_row * tk * HD;
  const __nv_bfloat16* vb = v + (size_t)kv_row * tk * HD;
  float* s_w = sm.s[warp];
  __nv_bfloat16* p_w = sm.p[warp];
  float* o_w = sm.o[warp];

  load_tile<HD>(sm.q, qb, q0, tq);
  for (int i = lane; i < 16 * LDO; i += 32) o_w[i] = 0.f;
  __syncthreads();
  FragA qa[HD / 16];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    wmma::load_matrix_sync(qa[kk], sm.q + (warp * 16) * LDH + kk * 16, LDH);
  }

  // two lanes per query row: 32 key columns and HD/2 output columns each
  const int r = lane >> 1;
  const int half = lane & 1;
  const int qpos = q0 + warp * 16 + r;
  float m_run = NEG;
  float l_run = 0.f;
  const int key_end = causal ? min(tk, q0 + BQ) : tk;

  for (int key0 = 0; key0 < key_end; key0 += BK) {
    __syncthreads();
    load_tile<HD>(sm.k, kb, key0, tk);
    load_tile<HD>(sm.v, vb, key0, tk);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        FragBc kf;
        wmma::load_matrix_sync(kf, sm.k + (j * 16) * LDH + kk * 16, LDH);
        wmma::mma_sync(acc, qa[kk], kf, acc);
      }
      wmma::store_matrix_sync(s_w + j * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    const float* row = s_w + r * LDS + half * 32;
    __nv_bfloat16* prow = p_w + r * LDP + half * 32;
    const int kbase = key0 + half * 32;
    float mt = NEG;
    for (int c = 0; c < 32; ++c) {
      const int kpos = kbase + c;
      if (kpos < tk && (!causal || kpos <= qpos)) mt = fmaxf(mt, row[c]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 1));
    const float m_new = fmaxf(m_run, mt);
    float sum = 0.f;
    for (int c = 0; c < 32; ++c) {
      const int kpos = kbase + c;
      const bool valid = kpos < tk && (!causal || kpos <= qpos);
      const float pv = valid ? expf(row[c] - m_new) : 0.f;
      sum += pv;
      prow[c] = __float2bfloat16_rn(pv);
    }
    sum += __shfl_xor_sync(FULL, sum, 1);
    const float alpha = expf(m_run - m_new);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    float* orow = o_w + r * LDO + half * (HD / 2);
    for (int c = 0; c < HD / 2; ++c) orow[c] *= alpha;
    __syncwarp();

    FragA pa[BK / 16];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wmma::load_matrix_sync(pa[kk], p_w + kk * 16, LDP);
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      FragC acc;
      wmma::load_matrix_sync(acc, o_w + n * 16, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        FragBr vf;
        wmma::load_matrix_sync(vf, sm.v + (kk * 16) * LDH + n * 16, LDH);
        wmma::mma_sync(acc, pa[kk], vf, acc);
      }
      wmma::store_matrix_sync(o_w + n * 16, acc, LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (qpos < tq) {
    const float inv = 1.f / fmaxf(l_run, 1e-30f);
    const float* orow = o_w + r * LDO + half * (HD / 2);
    __nv_bfloat16* ob = out + ((size_t)bh * tq + qpos) * HD + half * (HD / 2);
    for (int c = 0; c < HD / 2; ++c) ob[c] = __float2bfloat16_rn(orow[c] * inv);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int b, int h,
           int kvh, int tq, int tk, int causal, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem<HD>);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((tq + BQ - 1) / BQ, b * h);
  flash_attn_kernel<HD><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)out, h, kvh, tq, tk, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wmt_flash_attention(const void* q, const void* k, const void* v,
                                   void* out, int b, int h, int kvh, int tq, int tk,
                                   int hd, int causal, void* stream) {
  if (b < 1 || h < 1 || kvh < 1 || h % kvh || tq < 1 || tk < 1 || b * h > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 16: return launch<16>(q, k, v, out, b, h, kvh, tq, tk, causal, s);
    case 32: return launch<32>(q, k, v, out, b, h, kvh, tq, tk, causal, s);
    case 64: return launch<64>(q, k, v, out, b, h, kvh, tq, tk, causal, s);
    case 128: return launch<128>(q, k, v, out, b, h, kvh, tq, tk, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
