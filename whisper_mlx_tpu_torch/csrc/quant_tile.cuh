// Group-affine dequant-matmul pieces shared by kernel K5 (quant_matmul.cu,
// weights (N, K / per_word) row-major) and kernel K6 (quant_matmul_mb.cu,
// weights N-contiguous): the bf16 helpers, the bf16x2 dequantization and
// the m16n8k16 mma of their few-row routes, the x loader, and the tiled
// tensor-core GEMM that serves bf16 x with more than 8 rows.
//
// The GEMM reads its weights through a policy W:
//   w.word(n, kw)          stored element kw of output column n: a packed
//                          word of PER_WORD codes (nibble/byte e is k =
//                          PER_WORD * kw + e), or one int8 code (PER_WORD 1)
//   W::N_MAJOR             true when neighbouring columns n are neighbouring
//                          addresses (K6): the weight tile loader then walks
//                          n fastest and reads columns n .. n + 3 in one
//                          load with w.word4(n, kw, v) instead of w.word
//   w.scale(n, g), w.bias(n, g)   fp32 affine of column n, group g
// Numerics (the TPU kernels'): each group's scale is rounded to bf16, each
// code * scale is rounded to bf16, the products with x accumulate in fp32;
// the bias enters as xg @ b^T in fp32, xg being x's per-group sums.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace wmt_quant {

using namespace nvcuda;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

// Two 4-bit codes in bits 0-3 and 16-19 of v -> bf16x2 round_bf16(c * s):
// a mask-and-or forms bf16x2 (128 + c) (0x4300 is 128, whose ulp is 1), then
// one bf16x2 FMA with s2 = (s, s) and ns2 = (-128 s, -128 s), s already
// rounded to bf16 (bit patterns), is exact before its one rounding: the
// TPU kernels' round_bf16(c * s) without a conversion unit (K5 and K6).
__device__ __forceinline__ uint32_t dequant_bf16x2(uint32_t v, uint32_t s2, uint32_t ns2) {
  const uint32_t pair = (v & 0x000F000Fu) | 0x43004300u;
  uint32_t w;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(w) : "r"(pair), "r"(s2), "r"(ns2));
  return w;
}

// bf16x2 (s, s) and (-128 s, -128 s) of an fp32 scale, s rounded to bf16
// first (-128 s is exact: a power of two)
__device__ __forceinline__ void scale_pairs(float scale, uint32_t& s2, uint32_t& ns2) {
  const float s = round_bf16(scale);
  const uint32_t hi = __float_as_uint(s) >> 16;
  const uint32_t nhi = __float_as_uint(-128.f * s) >> 16;
  s2 = hi | (hi << 16);
  ns2 = nhi | (nhi << 16);
}

// c += a @ b for one m16n8k16 tile, bf16 in, fp32 accumulate (mma.sync's
// register layout: a0 row g k 2t..2t+1, a1 row g + 8, a2 row g k 2t+8..,
// a3 row g + 8 k 2t+8..; b0 k 2t.. column g, b1 k 2t+8..; c0, c1 row g
// columns 2t, 2t+1, c2, c3 row g + 8; g = lane / 4, t = lane % 4)
__device__ __forceinline__ void mma_16816(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// VALS consecutive x values of one row, as floats; x + off 16-byte aligned
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

// ---------------------------------------------------------------------------
// Tiled GEMM: bf16 x, more rows. 64 x 64 output tiles, K in steps of 64; the
// x tile and the dequantized bf16 weight tile go to shared memory and wmma
// bf16 -> fp32 multiplies them; the fp32 bias term xg @ b^T is added in the
// epilogue from shared-memory chunks of 32 groups.
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

template <int BITS, int PER_WORD, class W>
__global__ void __launch_bounds__(GM_THREADS)
quant_gemm_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ xg, W w,
                  __nv_bfloat16* __restrict__ out, int m, int n, int k, int group_size) {
  constexpr int WPR = BK / PER_WORD;  // stored elements of one tile row
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
    if constexpr (W::N_MAJOR) {
      // columns n0 + r4 .. + 3 lie below the padded Np, which is a multiple of 4
      for (int i = tid; i < (BN / 4) * WPR; i += GM_THREADS) {
        const int r4 = (i % (BN / 4)) * 4;
        const int wc = i / (BN / 4);
        const int kk = wc * PER_WORD;
        uint32_t words[4] = {0u, 0u, 0u, 0u};
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        if (n0 + r4 < n) {
          w.word4(n0 + r4, k0 / PER_WORD + wc, words);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[j] = round_bf16(w.scale(n0 + r4 + j, (k0 + kk) / group_size));
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < PER_WORD; ++e) {
            ws[(r4 + j) * LDH + kk + e] =
                __float2bfloat16_rn((float)((words[j] >> (e * BITS)) & MASK) * s[j]);
          }
        }
      }
    } else {
      for (int i = tid; i < BN * WPR; i += GM_THREADS) {
        const int r = i / WPR;
        const int wc = i % WPR;
        const int kk = wc * PER_WORD;
        uint32_t word = 0u;
        float s = 0.f;
        if (n0 + r < n) {
          word = w.word(n0 + r, k0 / PER_WORD + wc);
          s = round_bf16(w.scale(n0 + r, (k0 + kk) / group_size));
        }
#pragma unroll
        for (int e = 0; e < PER_WORD; ++e) {
          ws[r * LDH + kk + e] = __float2bfloat16_rn((float)((word >> (e * BITS)) & MASK) * s);
        }
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
      const int rn = W::N_MAJOR ? i % BN : r;
      const int gn = W::N_MAJOR ? i / BN : gg;
      bs[rn * LDG + gn] = (n0 + rn < n && g0 + gn < groups) ? w.bias(n0 + rn, g0 + gn) : 0.f;
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

}  // namespace wmt_quant
