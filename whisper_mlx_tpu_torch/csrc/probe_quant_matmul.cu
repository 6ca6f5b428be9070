// The dequant-matmul probe variants for Hopper (sm_90a): seven ways to feed
// the same product x (M, K) @ dequant(W)^T from group-affine int4/int8
// weights, each reading the operand set its variant defines.
//
// Replaces: scripts/bench_quant_kernel.py: quant_matmul_variant with
// _accum_kernel (a) and _e1_kernel (b), quant_matmul_e2 (c), quant_matmul_e3
// (d), quant_matmul_e5 (e), quant_matmul_e6 (f), quant_matmul_e7 (g): the
// Pallas TPU kernels that probe how kernel K5's work may be split between
// the kernel and its caller.
//
//   variant  weights                 affines                       bias
//   a accum  words (N, K/pw)         raw fp32 (N, G), cast per word  in the weight
//   b e1     words (N, K/pw)         raw fp32 (N, G), cast per group in the weight
//   c e2     words (N, K/pw)         bf16 per-word tables (N, K/pw)  in the weight
//   d e3     words (N, K/pw)         bf16 per-word scale table       xg @ b^T, xg given
//   e e5     strided words: word c   raw fp32 (N, G)                 in the weight
//            holds columns c + i*K/pw
//   f e6     words (N, K/pw)         raw fp32 (N, G)                 xg @ b^T, xg given
//   g e7     transposed (K/8, N)     raw fp32 (N, G)                 xg @ (b - 128 s)^T
//
// Rounding points with bf16 x, those of the Pallas bodies: every scale and
// bias the kernel multiplies or adds is a bf16 value, code * scale is rounded
// to bf16, with the bias in the weight the sum is rounded to bf16 again, and
// all products with x (and xg) accumulate in fp32; (a) keeps one fp32 sum per
// bit plane and adds the planes at the end. (g) builds 128 + code as an exact
// bf16 by mask-and-or with 0x4300 on two fields of a word at a time and folds
// -128 s into the bias; its (128 + code) * s rounds eight times coarser than
// code * s, which is the error the probe exists to show. With fp32 x all of
// it is fp32 (the tables of c and d stay bf16 inputs).
//
// What bounds them on the H100 at the probe's 24 rows: the weight bytes (the
// logits matrix is 33 MB of codes and 8 MB of affines; c adds 4 and d 2 bytes
// a word). Simple design: no tensor cores. Variants a-f: one warp per output
// column, a lane takes 16 bytes of codes at a time, dequantizes them in
// registers and multiplies them into up to 8 rows of x read through L1;
// grid.y walks the rows 8 at a time. Variant g: its words are N-contiguous,
// so a warp takes 32 neighbouring columns (one coalesced load a word), the
// warps of a block split K, and shared memory adds their sums. `threads`
// (the launch width) stands where the TPU functions take their column tile.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "quant_tile.cuh"

namespace {

using namespace wmt_quant;

constexpr unsigned FULL = 0xffffffffu;
constexpr int RB = 8;  // rows of x per block
enum Variant { ACCUM = 0, E1 = 1, E2 = 2, E3 = 3, E5 = 4, E6 = 5, E7 = 6 };

template <bool BF16>
__device__ __forceinline__ float rnd(float v) {
  return BF16 ? round_bf16(v) : v;
}

template <bool BF16>
__device__ __forceinline__ float load_one(const void* p, size_t i) {
  if constexpr (BF16) return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
  return reinterpret_cast<const float*>(p)[i];
}

template <bool BF16>
__device__ __forceinline__ void store_one(void* p, size_t i, float v) {
  if constexpr (BF16) {
    reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    reinterpret_cast<float*>(p)[i] = v;
  }
}

// Variants a-f: one warp per output column `col`.
template <int V, int BITS, bool BF16>
__global__ void __launch_bounds__(512)
probe_rows_kernel(const void* __restrict__ x, const void* __restrict__ xg,
                  const int32_t* __restrict__ wq, const float* __restrict__ scales,
                  const float* __restrict__ biases,
                  const __nv_bfloat16* __restrict__ scale_w,
                  const __nv_bfloat16* __restrict__ bias_w, void* __restrict__ out,
                  int m, int n, int k, int group_size) {
  constexpr int PER_WORD = 32 / BITS;
  constexpr int VALS = 4 * PER_WORD;  // values in one 16-byte load of codes
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  constexpr bool BIAS_IN_WEIGHT = V == ACCUM || V == E1 || V == E2 || V == E5;
  constexpr int PLANES = V == ACCUM ? PER_WORD : 1;  // fp32 sums kept apart
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * (blockDim.x >> 5) + warp;
  if (col >= n) return;
  const int m0 = blockIdx.y * RB;
  const int mcount = min(RB, m - m0);
  const int words = k / PER_WORD;
  const int groups = k / group_size;
  const uint4* wrow = reinterpret_cast<const uint4*>(wq + (size_t)col * words);
  const float* srow = scales + (size_t)col * groups;
  const float* brow = biases + (size_t)col * groups;

  float acc[PLANES][RB];
#pragma unroll
  for (int p = 0; p < PLANES; ++p) {
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[p][r] = 0.f;
  }

  for (int c = lane; c < words / 4; c += 32) {
    const uint4 u = __ldg(wrow + c);
    const uint32_t wd[4] = {u.x, u.y, u.z, u.w};
    // w[j * PER_WORD + i]: word j of the four, bit plane i
    float w[VALS];
    if constexpr (V == E5) {
      // word 4c + j, plane i is column i * words + 4c + j: the four words
      // of a plane are neighbours in x and share a group
#pragma unroll
      for (int i = 0; i < PER_WORD; ++i) {
        const int g = (i * words + 4 * c) / group_size;
        const float s = rnd<BF16>(__ldg(srow + g));
        const float b = rnd<BF16>(__ldg(brow + g));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float v = (float)((wd[j] >> (i * BITS)) & MASK);
          w[j * PER_WORD + i] = rnd<BF16>(rnd<BF16>(v * s) + b);
        }
      }
    } else {
      const int g = c * VALS / group_size;
      float s_grp = 0.f, b_grp = 0.f;
      if constexpr (V == ACCUM || V == E1 || V == E6) s_grp = __ldg(srow + g);
      if constexpr (V == ACCUM || V == E1) b_grp = __ldg(brow + g);
      if constexpr (V == E1 || V == E6) s_grp = rnd<BF16>(s_grp);  // cast, then spread
      if constexpr (V == E1) b_grp = rnd<BF16>(b_grp);
      uint2 st = make_uint2(0u, 0u), bt = make_uint2(0u, 0u);  // four bf16 table entries
      if constexpr (V == E2 || V == E3) {
        st = __ldg(reinterpret_cast<const uint2*>(scale_w + (size_t)col * words) + c);
      }
      if constexpr (V == E2) {
        bt = __ldg(reinterpret_cast<const uint2*>(bias_w + (size_t)col * words) + c);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = s_grp, b = b_grp;
        if constexpr (V == ACCUM) {  // spread in fp32, cast per word
          s = rnd<BF16>(s_grp);
          b = rnd<BF16>(b_grp);
        }
        if constexpr (V == E2 || V == E3) {
          s = bf16_bits_to_float(((j < 2 ? st.x : st.y) >> (16 * (j & 1))) & 0xffffu);
        }
        if constexpr (V == E2) {
          b = bf16_bits_to_float(((j < 2 ? bt.x : bt.y) >> (16 * (j & 1))) & 0xffffu);
        }
#pragma unroll
        for (int i = 0; i < PER_WORD; ++i) {
          const float v = rnd<BF16>((float)((wd[j] >> (i * BITS)) & MASK) * s);
          w[j * PER_WORD + i] = BIAS_IN_WEIGHT ? rnd<BF16>(v + b) : v;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < mcount) {
        const size_t row = (size_t)(m0 + r) * k;
        if constexpr (V == E5) {
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < PER_WORD; ++i) {
            float xv[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) xv[j] = load_one<BF16>(x, row + i * words + 4 * c + j);
#pragma unroll
            for (int j = 0; j < 4; ++j) dot = fmaf(xv[j], w[j * PER_WORD + i], dot);
          }
          acc[0][r] += dot;
        } else {
          float xv[VALS];
          load_x<BF16, VALS>(x, row + (size_t)c * VALS, xv);
          if constexpr (V == ACCUM) {
#pragma unroll
            for (int i = 0; i < PER_WORD; ++i) {
              float dot = 0.f;
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                dot = fmaf(xv[j * PER_WORD + i], w[j * PER_WORD + i], dot);
              }
              acc[i][r] += dot;
            }
          } else {
            float dot = 0.f;
#pragma unroll
            for (int e = 0; e < VALS; ++e) dot = fmaf(xv[e], w[e], dot);
            acc[0][r] += dot;
          }
        }
      }
    }
  }

  float total[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    total[r] = 0.f;
#pragma unroll
    for (int p = 0; p < PLANES; ++p) total[r] += acc[p][r];
  }
  if constexpr (!BIAS_IN_WEIGHT) {  // d, f: xg @ b^T, xg in x's dtype
    for (int g = lane; g < groups; g += 32) {
      const float b = rnd<BF16>(__ldg(brow + g));
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < mcount) total[r] = fmaf(load_one<BF16>(xg, (size_t)(m0 + r) * groups + g), b, total[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    float v = total[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
    if (lane == 0 && r < mcount) store_one<BF16>(out, (size_t)(m0 + r) * n + col, v);
  }
}

// Variant g: transposed words (K / 8, N), int4. A warp takes 32 neighbouring
// columns, the block's warps split the words, shared memory adds their sums.
constexpr int E7_MAX_WARPS = 16;

template <bool BF16>
__global__ void __launch_bounds__(512)
probe_e7_kernel(const void* __restrict__ x, const void* __restrict__ xg,
                const uint32_t* __restrict__ wqt, const float* __restrict__ scales,
                const float* __restrict__ biases, void* __restrict__ out,
                int m, int n, int k, int group_size) {
  __shared__ float red[E7_MAX_WARPS][RB][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const bool live = col < n;
  const int m0 = blockIdx.y * RB;
  const int mcount = min(RB, m - m0);
  const int words = k / 8;
  const int groups = k / group_size;
  const int per_warp = (words + warps - 1) / warps;
  const int kw_end = min(words, (warp + 1) * per_warp);

  float acc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = 0.f;
  for (int kw = warp * per_warp; kw < kw_end; ++kw) {
    uint32_t word = 0u;
    float s = 0.f;
    if (live) {
      word = __ldg(wqt + (size_t)kw * n + col);
      s = rnd<BF16>(__ldg(scales + (size_t)col * groups + kw * 8 / group_size));
    }
    // fields i and i + 4 land in the two halves of one word as the exact
    // bf16 values 128 + code; w[i] is column 8 kw + i
    float w[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t t = ((word >> (4 * i)) & 0x000f000fu) | 0x43004300u;
      w[i] = rnd<BF16>(bf16_bits_to_float(t & 0xffffu) * s);
      w[i + 4] = rnd<BF16>(bf16_bits_to_float(t >> 16) * s);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < mcount) {
        float xv[8];
        load_x<BF16, 8>(x, (size_t)(m0 + r) * k + (size_t)kw * 8, xv);
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) dot = fmaf(xv[e], w[e], dot);
        acc[r] += dot;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RB; ++r) red[warp][r][lane] = acc[r];
  __syncthreads();
  if (warp != 0 || !live) return;
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    for (int w2 = 1; w2 < warps; ++w2) acc[r] += red[w2][r][lane];
  }
  for (int g = 0; g < groups; ++g) {
    const float s = rnd<BF16>(__ldg(scales + (size_t)col * groups + g));
    const float b2 = rnd<BF16>(rnd<BF16>(__ldg(biases + (size_t)col * groups + g)) - 128.f * s);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < mcount) acc[r] = fmaf(load_one<BF16>(xg, (size_t)(m0 + r) * groups + g), b2, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (r < mcount) store_one<BF16>(out, (size_t)(m0 + r) * n + col, acc[r]);
  }
}

struct Args {
  const void* x;
  const void* xg;
  const void* w;
  const float* scales;
  const float* biases;
  const __nv_bfloat16* scale_w;
  const __nv_bfloat16* bias_w;
  void* out;
  int m, n, k, group_size, threads;
  cudaStream_t stream;
};

template <int V, int BITS, bool BF16>
void launch_rows(const Args& a) {
  const int warps = a.threads / 32;
  const dim3 grid((a.n + warps - 1) / warps, (a.m + RB - 1) / RB);
  probe_rows_kernel<V, BITS, BF16><<<grid, a.threads, 0, a.stream>>>(
      a.x, a.xg, (const int32_t*)a.w, a.scales, a.biases, a.scale_w, a.bias_w, a.out,
      a.m, a.n, a.k, a.group_size);
}

template <int V>
void launch_variant(const Args& a, int bits, bool bf16) {
  if (bits == 4) {
    bf16 ? launch_rows<V, 4, true>(a) : launch_rows<V, 4, false>(a);
  } else {
    bf16 ? launch_rows<V, 8, true>(a) : launch_rows<V, 8, false>(a);
  }
}

}  // namespace

// variant: 0 accum, 1 e1, 2 e2, 3 e3, 4 e5, 5 e6, 6 e7. `w` is the variant's
// weight layout; xg (d, f, g), scale_w (c, d) and bias_w (c) may be null for
// the variants that do not read them.
extern "C" int wmt_probe_qmm(const void* x, const void* xg, const void* w, const void* scales,
                             const void* biases, const void* scale_w, const void* bias_w,
                             void* out, int m, int n, int k, int bits, int group_size,
                             int variant, int threads, int x_bf16, void* stream) {
  if (m < 1 || n < 1 || k < 1 || (bits != 4 && bits != 8) || variant < ACCUM || variant > E7 ||
      threads < 32 || threads > 512 || threads % 32) {
    return (int)cudaErrorInvalidValue;
  }
  const int vals = 128 / bits;
  if (group_size <= 0 || group_size % vals || k % group_size) return (int)cudaErrorInvalidValue;
  if ((m + RB - 1) / RB > 65535) return (int)cudaErrorInvalidValue;
  const Args a{x, xg, w, (const float*)scales, (const float*)biases,
               (const __nv_bfloat16*)scale_w, (const __nv_bfloat16*)bias_w, out,
               m, n, k, group_size, threads, (cudaStream_t)stream};
  const bool bf16 = x_bf16 != 0;
  switch (variant) {
    case ACCUM: launch_variant<ACCUM>(a, bits, bf16); break;
    case E1: launch_variant<E1>(a, bits, bf16); break;
    case E2: launch_variant<E2>(a, bits, bf16); break;
    case E3: launch_variant<E3>(a, bits, bf16); break;
    case E5: launch_variant<E5>(a, bits, bf16); break;
    case E6: launch_variant<E6>(a, bits, bf16); break;
    default: {
      if (bits != 4) return (int)cudaErrorInvalidValue;
      const dim3 grid((n + 31) / 32, (m + RB - 1) / RB);
      if (bf16) {
        probe_e7_kernel<true><<<grid, threads, 0, a.stream>>>(
            x, xg, (const uint32_t*)w, a.scales, a.biases, out, m, n, k, group_size);
      } else {
        probe_e7_kernel<false><<<grid, threads, 0, a.stream>>>(
            x, xg, (const uint32_t*)w, a.scales, a.biases, out, m, n, k, group_size);
      }
    }
  }
  return (int)cudaGetLastError();
}
