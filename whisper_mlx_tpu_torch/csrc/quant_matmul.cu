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
// - quant_gemm_kernel (bf16, M > 8): 64 x 64 output tiles, K in steps of 64;
//   the x tile and the dequantized bf16 weight tile go to shared memory and
//   wmma bf16 -> fp32 multiplies them; the fp32 bias term xg @ b^T is added
//   in the epilogue from shared-memory chunks of 32 groups.
// Not yet wgmma/TMA or a pipelined weight stream: that is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

// ---------------------------------------------------------------------------
// GEMV: few rows
// ---------------------------------------------------------------------------

constexpr int GV_WARPS = 8;
constexpr int GV_ROWS = 8;  // rows of x per block (grid.y walks the rest)

// VALS consecutive x values of one row, as floats
template <bool BF16, int VALS>
__device__ __forceinline__ void load_x(const void* x, size_t off, float (&xv)[VALS]) {
  if constexpr (BF16) {
    const uint4* p = reinterpret_cast<const uint4*>(
        reinterpret_cast<const __nv_bfloat16*>(x) + off);
#pragma unroll
    for (int j = 0; j < VALS / 8; ++j) {
      const uint4 u = __ldg(p + j);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xv[j * 8 + 2 * e] = bf16_bits_to_float(w[e] & 0xffffu);
        xv[j * 8 + 2 * e + 1] = bf16_bits_to_float(w[e] >> 16);
      }
    }
  } else {
    const float4* p = reinterpret_cast<const float4*>(
        reinterpret_cast<const float*>(x) + off);
#pragma unroll
    for (int j = 0; j < VALS / 4; ++j) {
      const float4 f = __ldg(p + j);
      xv[j * 4] = f.x;
      xv[j * 4 + 1] = f.y;
      xv[j * 4 + 2] = f.z;
      xv[j * 4 + 3] = f.w;
    }
  }
}

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

// ---------------------------------------------------------------------------
// GEMM: bf16, more rows
// ---------------------------------------------------------------------------

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int GM_THREADS = 128;
constexpr int LDH = BK + 8;   // bf16 row stride of the x and weight tiles
constexpr int LDC = BN + 4;   // fp32 row stride of the output tile
constexpr int GCH = 32;       // groups per bias chunk
constexpr int LDG = GCH + 1;  // fp32 row stride of the bias chunks

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int TILE_BYTES = 2 * BM * LDH * 2;  // x tile + weight tile, bf16
constexpr int CHUNK_BYTES = 2 * BM * LDG * 4;  // xg chunk + bias chunk, fp32
static_assert(CHUNK_BYTES <= TILE_BYTES, "bias chunks reuse the tile space");

template <int BITS>
__global__ void __launch_bounds__(GM_THREADS)
quant_gemm_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ xg,
                  const int32_t* __restrict__ wq, const float* __restrict__ scales,
                  const float* __restrict__ biases, __nv_bfloat16* __restrict__ out,
                  int m, int n, int k, int group_size) {
  constexpr int PER_WORD = 32 / BITS;
  constexpr int WPR = BK / PER_WORD;  // words of one tile row
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  __shared__ __align__(128) unsigned char tiles[TILE_BYTES];
  __shared__ __align__(128) float cs[BM * LDC];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(tiles);
  __nv_bfloat16* ws = xs + BM * LDH;
  float* xgs = reinterpret_cast<float*>(tiles);
  float* bs = xgs + BM * LDG;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int words = k / PER_WORD;
  const int groups = k / group_size;

  FragC acc[BN / 16];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int k0 = 0; k0 < k; k0 += BK) {
    __syncthreads();
    for (int i = tid; i < BM * (BK / 8); i += GM_THREADS) {
      const int r = i / (BK / 8);
      const int c = i % (BK / 8);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < m) v = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * k + k0) + c);
      *reinterpret_cast<uint4*>(xs + r * LDH + c * 8) = v;
    }
    for (int i = tid; i < BN * WPR; i += GM_THREADS) {
      const int r = i / WPR;
      const int wc = i % WPR;
      const int kk = wc * PER_WORD;
      uint32_t word = 0u;
      float s = 0.f;
      if (n0 + r < n) {
        word = (uint32_t)__ldg(wq + (size_t)(n0 + r) * words + k0 / PER_WORD + wc);
        s = round_bf16(__ldg(scales + (size_t)(n0 + r) * groups + (k0 + kk) / group_size));
      }
#pragma unroll
      for (int e = 0; e < PER_WORD; ++e) {
        ws[r * LDH + kk + e] = __float2bfloat16_rn((float)((word >> (e * BITS)) & MASK) * s);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      FragA a;
      wmma::load_matrix_sync(a, xs + (warp * 16) * LDH + kk * 16, LDH);
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        FragB b;
        wmma::load_matrix_sync(b, ws + (j * 16) * LDH + kk * 16, LDH);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) {
    wmma::store_matrix_sync(cs + (warp * 16) * LDC + j * 16, acc[j], LDC, wmma::mem_row_major);
  }

  // bias: xg (BM x groups) @ b^T (groups x BN), fp32, in chunks of GCH groups
  const int c = tid % BN;
  const int rb = tid / BN;  // 0 .. GM_THREADS / BN - 1
  constexpr int RSTEP = GM_THREADS / BN;
  float bacc[BM / RSTEP];
#pragma unroll
  for (int j = 0; j < BM / RSTEP; ++j) bacc[j] = 0.f;
  for (int g0 = 0; g0 < groups; g0 += GCH) {
    __syncthreads();
    for (int i = tid; i < BM * GCH; i += GM_THREADS) {
      const int r = i / GCH;
      const int gg = i % GCH;
      const int g = g0 + gg;
      xgs[r * LDG + gg] = (m0 + r < m && g < groups) ? __ldg(xg + (size_t)(m0 + r) * groups + g) : 0.f;
      bs[r * LDG + gg] = (n0 + r < n && g < groups) ? __ldg(biases + (size_t)(n0 + r) * groups + g) : 0.f;
    }
    __syncthreads();
    for (int gg = 0; gg < GCH; ++gg) {
      const float bv = bs[c * LDG + gg];
#pragma unroll
      for (int j = 0; j < BM / RSTEP; ++j) bacc[j] = fmaf(xgs[(rb + RSTEP * j) * LDG + gg], bv, bacc[j]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < BM / RSTEP; ++j) {
    const int r = rb + RSTEP * j;
    if (m0 + r < m && n0 + c < n) {
      out[(size_t)(m0 + r) * n + n0 + c] = __float2bfloat16_rn(cs[r * LDC + c] + bacc[j]);
    }
  }
}

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
  if (bits == 4) {
    quant_gemm_kernel<4><<<grid, GM_THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)xg, (const int32_t*)wq,
        (const float*)scales, (const float*)biases, (__nv_bfloat16*)out, m, n, k, group_size);
  } else {
    quant_gemm_kernel<8><<<grid, GM_THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)xg, (const int32_t*)wq,
        (const float*)scales, (const float*)biases, (__nv_bfloat16*)out, m, n, k, group_size);
  }
  return (int)cudaGetLastError();
}
