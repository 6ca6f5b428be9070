// Fused dequant-matmul over MLX group-affine int4/int8 weights for Hopper
// (sm_90a).
//
// Replaces: whisper_mlx_tpu/ops/quant_pallas.py:quant_matmul_pallas
// (_quant_matmul_kernel), the Pallas TPU kernel that every Qwen projection
// and the whisper 4-bit decode take at <= 512 rows.
//
// Computes out (M, N) = x (M, K) @ (s * v + b)^T, with v the codes packed
// 8 (int4) or 4 (int8) to a 32-bit word in MLX order (nibble i of word w is
// column per_word * w + i), s and b fp32 per (row, group of group_size).
// Numerics of the TPU kernel: with bf16 x, s is rounded to bf16 and every
// code * s to bf16, products with x accumulate in fp32; with fp32 x all is
// fp32. The bias enters as xg @ b^T in fp32, xg being x's per-group sums.
//
// What bounds it on the H100: at decode (M = 1..8) the bytes of the weight
// stream. A Qwen3-32B step reads 16 GB of codes and 4 GB of fp32 affines:
// 6 ms at 3.35 TB/s. Prefill (M = 128..512) is a GEMM: tensor cores.
//
// Simple design, two kernels:
// - quant_gemv_kernel (M <= 8, or fp32 x): one warp per output row; each
//   lane loads 16 bytes of codes (32 int4 / 16 int8 values of one group),
//   dequantizes them in registers with the rounding above, and takes their
//   dot product with up to 8 rows of x (read through L1); a warp shuffle
//   reduces. The bias is folded per lane as b * sum(x) over the lane's span.
// - quant_gemm_kernel (bf16, M > 8; quant_tile.cuh, shared with K6): 64 x 64
//   output tiles, K in steps of 64; the x tile and the dequantized bf16
//   weight tile go to shared memory and wmma bf16 -> fp32 multiplies them;
//   the fp32 bias term xg @ b^T is added in the epilogue.
// Not yet wgmma/TMA or a pipelined weight stream: that is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "quant_tile.cuh"

namespace {

using namespace wmt_quant;

constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// GEMV: few rows
// ---------------------------------------------------------------------------

constexpr int GV_WARPS = 8;
constexpr int GV_ROWS = 8;  // rows of x per block (grid.y walks the rest)

template <int BITS, bool BF16>
__global__ void __launch_bounds__(GV_WARPS * 32)
quant_gemv_kernel(const void* __restrict__ x, const int32_t* __restrict__ wq,
                  const float* __restrict__ scales, const float* __restrict__ biases,
                  void* __restrict__ out, int m, int n, int k, int group_size) {
  constexpr int PER_WORD = 32 / BITS;
  constexpr int VALS = 4 * PER_WORD;  // values in one 16-byte load of codes
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * GV_WARPS + warp;
  if (row >= n) return;
  const int m0 = blockIdx.y * GV_ROWS;
  const int mcount = min(GV_ROWS, m - m0);
  const int words = k / PER_WORD;
  const int groups = k / group_size;
  const uint4* wrow = reinterpret_cast<const uint4*>(wq + (size_t)row * words);
  const float* srow = scales + (size_t)row * groups;
  const float* brow = biases + (size_t)row * groups;

  float acc[GV_ROWS];
#pragma unroll
  for (int r = 0; r < GV_ROWS; ++r) acc[r] = 0.f;

  for (int c = lane; c < words / 4; c += 32) {
    const uint4 u = __ldg(wrow + c);
    const int kbase = c * VALS;
    const int g = kbase / group_size;
    float s = __ldg(srow + g);
    const float b = __ldg(brow + g);
    if (BF16) s = round_bf16(s);
    const uint32_t wd[4] = {(uint32_t)u.x, (uint32_t)u.y, (uint32_t)u.z, (uint32_t)u.w};
    float w[VALS];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < PER_WORD; ++i) {
        const float v = (float)((wd[j] >> (i * BITS)) & MASK) * s;
        w[j * PER_WORD + i] = BF16 ? round_bf16(v) : v;
      }
    }
#pragma unroll
    for (int r = 0; r < GV_ROWS; ++r) {
      if (r < mcount) {
        float xv[VALS];
        load_x<BF16, VALS>(x, (size_t)(m0 + r) * k + kbase, xv);
        float dot = 0.f;
        float xs = 0.f;
#pragma unroll
        for (int e = 0; e < VALS; ++e) {
          dot = fmaf(xv[e], w[e], dot);
          xs += xv[e];
        }
        acc[r] += fmaf(xs, b, dot);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < GV_ROWS; ++r) {
    float v = acc[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
    if (lane == 0 && r < mcount) {
      const size_t o = (size_t)(m0 + r) * n + row;
      if (BF16) {
        reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
      } else {
        reinterpret_cast<float*>(out)[o] = v;
      }
    }
  }
}

// K5's weights for the tiled GEMM: words (N, K / per_word), affines (N, G)
struct RowWords {
  static constexpr bool N_MAJOR = false;
  const int32_t* wq;
  const float* scales;
  const float* biases;
  int words;
  int groups;
  __device__ __forceinline__ uint32_t word(int n, int kw) const {
    return (uint32_t)__ldg(wq + (size_t)n * words + kw);
  }
  __device__ __forceinline__ float scale(int n, int g) const {
    return __ldg(scales + (size_t)n * groups + g);
  }
  __device__ __forceinline__ float bias(int n, int g) const {
    return __ldg(biases + (size_t)n * groups + g);
  }
};

bool valid_quant(int m, int n, int k, int bits, int group_size) {
  if (m < 1 || n < 1 || k < 1 || (bits != 4 && bits != 8)) return false;
  const int vals = 128 / bits;
  return group_size > 0 && group_size % vals == 0 && k % group_size == 0;
}

}  // namespace

extern "C" int wmt_quant_gemv(const void* x, const void* wq, const void* scales,
                              const void* biases, void* out, int m, int n, int k,
                              int bits, int group_size, int x_bf16, void* stream) {
  if (!valid_quant(m, n, k, bits, group_size)) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + GV_WARPS - 1) / GV_WARPS, (m + GV_ROWS - 1) / GV_ROWS);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t* w = (const int32_t*)wq;
  const float* sc = (const float*)scales;
  const float* bi = (const float*)biases;
  if (bits == 4 && x_bf16) {
    quant_gemv_kernel<4, true><<<grid, GV_WARPS * 32, 0, s>>>(x, w, sc, bi, out, m, n, k, group_size);
  } else if (bits == 4) {
    quant_gemv_kernel<4, false><<<grid, GV_WARPS * 32, 0, s>>>(x, w, sc, bi, out, m, n, k, group_size);
  } else if (x_bf16) {
    quant_gemv_kernel<8, true><<<grid, GV_WARPS * 32, 0, s>>>(x, w, sc, bi, out, m, n, k, group_size);
  } else {
    quant_gemv_kernel<8, false><<<grid, GV_WARPS * 32, 0, s>>>(x, w, sc, bi, out, m, n, k, group_size);
  }
  return (int)cudaGetLastError();
}

extern "C" int wmt_quant_gemm(const void* x, const void* xg, const void* wq,
                              const void* scales, const void* biases, void* out,
                              int m, int n, int k, int bits, int group_size,
                              void* stream) {
  if (!valid_quant(m, n, k, bits, group_size) || k % BK) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const RowWords w{(const int32_t*)wq, (const float*)scales, (const float*)biases,
                   k / (32 / bits), k / group_size};
  if (bits == 4) {
    quant_gemm_kernel<4, 8><<<grid, GM_THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)xg, w, (__nv_bfloat16*)out, m, n, k, group_size);
  } else {
    quant_gemm_kernel<8, 4><<<grid, GM_THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)xg, w, (__nv_bfloat16*)out, m, n, k, group_size);
  }
  return (int)cudaGetLastError();
}
