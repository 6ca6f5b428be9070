// W8A8 matmul (kernel K7) for Hopper (sm_90a).
//
// Replaces: whisper_mlx_tpu/ops/quant_a8.py:a8_matmul (_a8_kernel), the
// Pallas TPU kernel that streams per-channel int8 codes through a DMA ring
// and multiplies them on the MXU with per-row dynamically quantized
// activations (WTPU_QWEN_A8).
//
// For x (M, K) and codes c (N, K) int8 with one fp32 scale s_n per output
// channel (the port stores the codes N-major, so the four k values that one
// __dp4a takes are one 32-bit word):
//   sx_m   = max(max_k |x_mk|, 1e-8) / 127                   (fp32)
//   q_mk   = clip(round_half_even(x_mk / sx_m), -127, 127)   (true division)
//   out_mn = (float(sum_k q_mk c_nk) * s_n) * sx_m          (int32 sum, fp32)
// and out is cast to x's dtype.
//
// What bounds it on the H100: at decode the bytes of the int8 code stream
// (one Qwen3-32B layer's four linears and the head: 1.27 GB, 0.378 ms at
// 3.35 TB/s). The integer dot costs one __dp4a per 4 bytes, well below what
// the SM can issue, and there is no per-value dequantization.
//
// Design:
// - a8_quantize_kernel: one block per row of x: a block reduction for the
//   absmax, then the row's codes and its scale. A launch of its own: every
//   output column needs the whole row's scale first.
// - a8_gemv_kernel (M <= 8): one warp per output channel; each lane loads
//   16 bytes of codes (16 k values) a step and __dp4a's them with up to 8
//   rows of quantized x (read through L1); an int32 warp reduction (exact).
// - a8_gemm_kernel (M > 8): 64 x 64 output tiles, K in steps of 64; the
//   quantized x tile and the code tile go to shared memory in 16-wide k
//   slices and wmma s8 x s8 -> s32 multiplies them.
// Not yet TMA or wgmma: later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr unsigned FULL = 0xffffffffu;

template <bool BF16>
__device__ __forceinline__ float x_at(const void* x, size_t i) {
  if constexpr (BF16) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(x)[i]);
  } else {
    return reinterpret_cast<const float*>(x)[i];
  }
}

// ---------------------------------------------------------------------------
// per-row dynamic int8 quantization of x
// ---------------------------------------------------------------------------

constexpr int Q_THREADS = 256;

template <bool BF16>
__global__ void __launch_bounds__(Q_THREADS)
a8_quantize_kernel(const void* __restrict__ x, int8_t* __restrict__ xq,
                   float* __restrict__ sx, int k) {
  __shared__ float part[Q_THREADS / 32];
  const size_t row = (size_t)blockIdx.x * k;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float amax = 0.f;
  for (int i = threadIdx.x; i < k; i += Q_THREADS) {
    amax = fmaxf(amax, fabsf(x_at<BF16>(x, row + i)));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(FULL, amax, off));
  if (lane == 0) part[warp] = amax;
  __syncthreads();
  amax = 0.f;
#pragma unroll
  for (int j = 0; j < Q_THREADS / 32; ++j) amax = fmaxf(amax, part[j]);
  const float scale = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
  for (int i = threadIdx.x; i < k; i += Q_THREADS) {
    const float q = rintf(__fdiv_rn(x_at<BF16>(x, row + i), scale));  // half to even
    xq[row + i] = (int8_t)fminf(fmaxf(q, -127.f), 127.f);
  }
  if (threadIdx.x == 0) sx[blockIdx.x] = scale;
}

template <bool BF16>
__device__ __forceinline__ void store_out(void* out, size_t o, int acc, float s_n, float s_m) {
  const float v = (__int2float_rn(acc) * s_n) * s_m;
  if constexpr (BF16) {
    reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
  } else {
    reinterpret_cast<float*>(out)[o] = v;
  }
}

// ---------------------------------------------------------------------------
// GEMV: few rows
// ---------------------------------------------------------------------------

constexpr int GV_WARPS = 8;
constexpr int GV_ROWS = 8;  // rows of x per block (grid.y walks the rest)

template <bool BF16>
__global__ void __launch_bounds__(GV_WARPS * 32)
a8_gemv_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
               const int8_t* __restrict__ codes, const float* __restrict__ scale,
               void* __restrict__ out, int m, int n, int k) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ch = blockIdx.x * GV_WARPS + warp;
  if (ch >= n) return;
  const int m0 = blockIdx.y * GV_ROWS;
  const int mcount = min(GV_ROWS, m - m0);
  const int4* crow = reinterpret_cast<const int4*>(codes + (size_t)ch * k);

  int acc[GV_ROWS];
#pragma unroll
  for (int r = 0; r < GV_ROWS; ++r) acc[r] = 0;
#pragma unroll 4
  for (int c = lane; c < k / 16; c += 32) {
    const int4 wv = __ldg(crow + c);
#pragma unroll
    for (int r = 0; r < GV_ROWS; ++r) {
      if (r < mcount) {
        const int4 xv = __ldg(reinterpret_cast<const int4*>(xq + (size_t)(m0 + r) * k) + c);
        acc[r] = __dp4a(xv.x, wv.x, acc[r]);
        acc[r] = __dp4a(xv.y, wv.y, acc[r]);
        acc[r] = __dp4a(xv.z, wv.z, acc[r]);
        acc[r] = __dp4a(xv.w, wv.w, acc[r]);
      }
    }
  }
  const float s_n = __ldg(scale + ch);
#pragma unroll
  for (int r = 0; r < GV_ROWS; ++r) {
    int v = acc[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
    if (lane == 0 && r < mcount) {
      store_out<BF16>(out, (size_t)(m0 + r) * n + ch, v, s_n, __ldg(sx + m0 + r));
    }
  }
}

// ---------------------------------------------------------------------------
// GEMM: more rows, int8 tensor cores
// ---------------------------------------------------------------------------

constexpr int TM = 64;
constexpr int TN = 64;
constexpr int TK = 64;
constexpr int KS = 16;  // k slice of one wmma step
constexpr int GM_THREADS = 128;
constexpr int LDC = TN + 4;  // int32 row stride of the output tile

using IFragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major>;
using IFragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major>;
using IFragC = wmma::fragment<wmma::accumulator, 16, 16, 16, int>;

template <bool BF16>
__global__ void __launch_bounds__(GM_THREADS)
a8_gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
               const int8_t* __restrict__ codes, const float* __restrict__ scale,
               void* __restrict__ out, int m, int n, int k) {
  // tiles stored as 16-wide k slices (slice, row, 16): every fragment
  // pointer is 32-byte aligned and its leading dimension is 16
  __shared__ __align__(128) signed char as[TK / KS][TM][KS];
  __shared__ __align__(128) signed char bs[TK / KS][TN][KS];
  __shared__ __align__(128) int cs[TM * LDC];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;

  IFragC acc[TN / 16];
#pragma unroll
  for (int j = 0; j < TN / 16; ++j) wmma::fill_fragment(acc[j], 0);

  for (int k0 = 0; k0 < k; k0 += TK) {
    __syncthreads();
    for (int i = tid; i < TM * (TK / KS); i += GM_THREADS) {
      const int r = i / (TK / KS);
      const int q = i % (TK / KS);
      int4 a = make_int4(0, 0, 0, 0);
      int4 b = make_int4(0, 0, 0, 0);
      if (m0 + r < m) {
        a = __ldg(reinterpret_cast<const int4*>(xq + (size_t)(m0 + r) * k + k0) + q);
      }
      if (n0 + r < n) {
        b = __ldg(reinterpret_cast<const int4*>(codes + (size_t)(n0 + r) * k + k0) + q);
      }
      *reinterpret_cast<int4*>(&as[q][r][0]) = a;
      *reinterpret_cast<int4*>(&bs[q][r][0]) = b;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < TK / KS; ++q) {
      IFragA fa;
      wmma::load_matrix_sync(fa, &as[q][warp * 16][0], KS);
#pragma unroll
      for (int j = 0; j < TN / 16; ++j) {
        IFragB fb;
        wmma::load_matrix_sync(fb, &bs[q][j * 16][0], KS);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < TN / 16; ++j) {
    wmma::store_matrix_sync(cs + (warp * 16) * LDC + j * 16, acc[j], LDC, wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = tid; i < TM * TN; i += GM_THREADS) {
    const int r = i / TN;
    const int c = i % TN;
    if (m0 + r < m && n0 + c < n) {
      store_out<BF16>(out, (size_t)(m0 + r) * n + n0 + c, cs[r * LDC + c], __ldg(scale + n0 + c),
                      __ldg(sx + m0 + r));
    }
  }
}

}  // namespace

extern "C" int wmt_a8_quantize(const void* x, void* xq, void* sx, int m, int k, int x_bf16,
                               void* stream) {
  if (m < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16) {
    a8_quantize_kernel<true><<<m, Q_THREADS, 0, s>>>(x, (int8_t*)xq, (float*)sx, k);
  } else {
    a8_quantize_kernel<false><<<m, Q_THREADS, 0, s>>>(x, (int8_t*)xq, (float*)sx, k);
  }
  return (int)cudaGetLastError();
}

extern "C" int wmt_a8_matmul(const void* xq, const void* sx, const void* codes,
                             const void* scale, void* out, int m, int n, int k, int out_bf16,
                             void* stream) {
  if (m < 1 || n < 1 || k < 16 || k % 16) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int8_t* q = (const int8_t*)xq;
  const float* sxf = (const float*)sx;
  const int8_t* c = (const int8_t*)codes;
  const float* sc = (const float*)scale;
  if (m <= GV_ROWS || k % TK) {
    const dim3 grid((n + GV_WARPS - 1) / GV_WARPS, (m + GV_ROWS - 1) / GV_ROWS);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    if (out_bf16) {
      a8_gemv_kernel<true><<<grid, GV_WARPS * 32, 0, s>>>(q, sxf, c, sc, out, m, n, k);
    } else {
      a8_gemv_kernel<false><<<grid, GV_WARPS * 32, 0, s>>>(q, sxf, c, sc, out, m, n, k);
    }
  } else {
    const dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    if (out_bf16) {
      a8_gemm_kernel<true><<<grid, GM_THREADS, 0, s>>>(q, sxf, c, sc, out, m, n, k);
    } else {
      a8_gemm_kernel<false><<<grid, GM_THREADS, 0, s>>>(q, sxf, c, sc, out, m, n, k);
    }
  }
  return (int)cudaGetLastError();
}
