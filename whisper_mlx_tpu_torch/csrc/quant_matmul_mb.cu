// Multi-buffered transposed dequant-matmul (kernel K6) for Hopper (sm_90a).
//
// Replaces: whisper_mlx_tpu/ops/quant_pallas_mb.py:quant_matmul_mbt
// (_mbt_kernel), the Pallas TPU kernel that streams N-contiguous weight
// slabs through a DEPTH-deep ring of DMAs (WTPU_MBT_RESIDENT, WTPU_QMM_MB).
//
// Computes out (M, N) = x (M, K) @ (s * v + b)^T, the function of K5
// (quant_matmul.cu) with K5's numerics, from the transposed layouts of
// ops/quant_matmul_mb.py:QuantTensorT:
//   packed  words (Kp, Np) int32, Kp = K / per_word; word kw of column n
//           holds k = per_word * kw + e in nibble (int4) or byte (int8) e;
//   codes   (K, Np) int8, one 4-bit code per byte (WTPU_MBT_DQ=i8);
// stored element (row r, column n) sits at r * Np + n; scales and biases
// are (G, Np) fp32.
//
// What bounds it on the H100: at decode the bytes of the weight stream (one
// Qwen3-32B layer's four linears: 304.7 MB of int4 codes and fp32 affines,
// 0.091 ms at 3.35 TB/s). Dequantizing in SIMT does not get there: int ->
// float and float -> bf16 conversions issue at 16 a clock per SM, an eighth
// of the fp32 rate, and two per value cap the stream near 0.9 TB/s.
//
// Design, two routes:
// - mbt_gemv_kernel (M <= 8, or fp32 x), the TPU kernel's ring on the card:
//   a block owns 256 columns and one split of the stored rows. It streams
//   the split through a ring of `stages` (the layout's `depth`, at most 8)
//   shared-memory slots with 16-byte cp.async copies, so up to `stages - 1`
//   slots are in flight while the block works on the slot that has landed.
//   A slot holds 8 KB of codes (rows x 256 columns), the scales and biases
//   of the (at most two) groups they touch, and the slot's x, so nothing in
//   the loop waits on device memory. With bf16 x and 4-bit codes the tensor
//   cores take the products: each warp owns 32 columns as four interleaved
//   m16n8k16 tiles (x rows 0-7, zero rows 8-15; a lane's four columns are
//   neighbours, one 16-byte load), and the mma's k order is permuted
//   within each 16 k so that a lane's B pair is codes k and k + 4 of one
//   word: a mask-and-or makes bf16x2 (128 + c), and one bf16x2 FMA computes
//   (128 + c) * s - 128 * s, exact before its single rounding, i.e. the TPU
//   kernel's round_bf16(c * round_bf16(s)) without a conversion unit. fp32
//   x and 8-bit codes run one column per thread in registers. The bias
//   enters once per group as xg * b, from the sums of x over each group's
//   part in the split, taken when the block starts. Narrow linears split K
//   over several blocks (about four per SM, the most that fit); a second
//   kernel sums the fp32 partials in a fixed order.
// - quant_gemm_kernel (bf16, M > 8; quant_tile.cuh, shared with K5) reads
//   the weights N-contiguous, four columns a load.
// Measured on the card at M = 1: packed int4 1.0-1.1 TB/s, codes-resident
// int8 1.3-1.8 TB/s; neither the ring's depth, the number of splits nor a
// tiled layout (the reference's contig, 256-column tiles) lifts packed int4
// further, and what holds it there is open (PERF.md).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "quant_tile.cuh"
#include "sm90_async.cuh"

namespace {

using namespace wmt_quant;
using namespace wmt_async;

constexpr int MB_THREADS = 256;  // columns of a block
constexpr int MB_CODES = 8192;   // code bytes of one ring slot
constexpr int MB_AFF = 4 * MB_THREADS * 4;  // scales and biases of two groups
constexpr int MB_ROWS = 8;       // rows of x per block (grid.z walks the rest)
constexpr int MB_XS = MB_ROWS * 64 * 2;     // the slot's x (bf16, at most 64 k)
constexpr int MB_SLOT = MB_CODES + MB_AFF + MB_XS;
constexpr int MB_MAX_STAGES = 8;
constexpr int XG_LANES = 8;    // threads that sum one (row, group) of x

// BITS 4 or 8: packed words; 0: int8 codes, one per byte
template <int BITS, bool BF16>
__global__ void __launch_bounds__(MB_THREADS, 4)  // four blocks per SM: at most 64 registers
mbt_gemv_kernel(const void* __restrict__ x, const unsigned char* __restrict__ w,
                const float* __restrict__ scales, const float* __restrict__ biases,
                void* __restrict__ out, float* __restrict__ partial, int m, int n, int k,
                int group_size, int np, int stages, int rows_per_split, int xg_stride) {
  constexpr int ESZ = BITS ? 4 : 1;            // bytes of one stored element
  constexpr int VPE = BITS ? 32 / BITS : 1;    // k values of one stored element
  constexpr int EPU = 8 / VPE;                 // stored rows of 8 k values
  constexpr int ROW_BYTES = MB_THREADS * ESZ;  // one slot row: 256 columns
  constexpr int SR = MB_CODES / ROW_BYTES;     // slot rows: 8 packed, 32 codes
  constexpr int CPR = ROW_BYTES / 16;          // 16-byte copies of a slot row
  constexpr int ROW_STEP = MB_THREADS / CPR;
  constexpr int COPIES = SR / ROW_STEP;        // code copies of a thread per slot
  constexpr uint32_t MASK = BITS ? (1u << BITS) - 1u : 0xffu;
  // bf16 x with 4-bit codes (packed or one per byte): tensor cores
  constexpr bool MMA = BF16 && BITS != 8;
  constexpr int SLOT_K = SR * VPE;             // k values of a slot: 64 or 32
  constexpr int XCH = SLOT_K * 2 / 16;         // 16-byte copies of a row of the slot's x
  static_assert(MB_ROWS * SLOT_K * 2 <= MB_XS && MB_ROWS * XCH <= MB_THREADS, "slot x");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* xg_s = reinterpret_cast<float*>(smem + stages * MB_SLOT);  // (MB_ROWS, xg_stride)

  const int tid = threadIdx.x;
  const int col = blockIdx.x * MB_THREADS + tid;
  const bool active = col < n;
  const int m0 = blockIdx.z * MB_ROWS;
  const int mcount = min(MB_ROWS, m - m0);
  const int groups = k / group_size;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(k / VPE, r_begin + rows_per_split);
  const int n_slots = max(0, (r_end - r_begin + SR - 1) / SR);

  // code copies: 16 bytes (byte cc * 16 of the slot row) of rows crow,
  // crow + ROW_STEP, ... of every slot
  const int cc = tid % CPR;
  const int crow = tid / CPR;
  const int ccol = blockIdx.x * MB_THREADS + cc * (16 / ESZ);
  const bool cvalid = ccol < np;
  // affine copies: 4 columns of scales (which 0, 1: the slot's first group
  // and the next) or biases (which 2, 3)
  const int which = tid / (MB_THREADS / 4);
  const int acol = blockIdx.x * MB_THREADS + (tid % (MB_THREADS / 4)) * 4;
  const float* asrc = which < 2 ? scales : biases;

  auto issue = [&](int slot) {  // copy the split's slot `slot` into the ring
    if (slot < n_slots) {
      unsigned char* dst = ring + (slot % stages) * MB_SLOT;
      const int r0 = r_begin + slot * SR;
#pragma unroll
      for (int j = 0; j < COPIES; ++j) {
        const int rr = crow + j * ROW_STEP;
        const bool ok = cvalid && r0 + rr < r_end;
        const unsigned char* src = ok ? w + ((long long)(r0 + rr) * np + ccol) * ESZ : w;
        cp_async16(dst + rr * ROW_BYTES + cc * 16, src, ok);
      }
      const int g = r0 * VPE / group_size + (which & 1);
      const bool ok = g < groups && acol < np;
      cp_async16(dst + MB_CODES + which * MB_THREADS * 4 + (tid % (MB_THREADS / 4)) * 16,
                 ok ? asrc + (size_t)g * np + acol : scales, ok);
      if constexpr (MMA) {  // the slot's x: MB_ROWS rows of SLOT_K bf16
        if (tid < MB_ROWS * XCH) {
          const int xr = tid / XCH;
          const int xk = r0 * VPE + (tid % XCH) * 8;
          const bool xok = xr < mcount && xk < r_end * VPE;
          cp_async16(dst + MB_CODES + MB_AFF + tid * 16,
                     xok ? reinterpret_cast<const __nv_bfloat16*>(x) + (size_t)(m0 + xr) * k + xk
                         : x, xok);
        }
      }
    }
    cp_async_commit();  // one group per call, empty or not, so the count holds
  };

  for (int slot = 0; slot < stages - 1; ++slot) issue(slot);

  // x summed over each group's part in this split (the bias term's xg),
  // XG_LANES threads to a (row, group), while the first slots land
  const int k_begin = r_begin * VPE;
  const int k_end = r_end * VPE;
  const int g_begin = k_begin / group_size;
  const int n_groups = r_end > r_begin ? (k_end - 1) / group_size - g_begin + 1 : 0;
  for (int base = 0; base < mcount * n_groups; base += MB_THREADS / XG_LANES) {
    const int p = base + tid / XG_LANES;
    float sum = 0.f;
    if (p < mcount * n_groups) {
      const int r = p / n_groups;
      const int g = g_begin + p % n_groups;
      const int hi = min(g * group_size + group_size, k_end);
      for (int kk = max(g * group_size, k_begin) + (tid % XG_LANES) * 8; kk < hi;
           kk += XG_LANES * 8) {
        float xv[8];
        load_x<BF16, 8>(x, (size_t)(m0 + r) * k + kk, xv);
#pragma unroll
        for (int e = 0; e < 8; ++e) sum += xv[e];
      }
    }
#pragma unroll
    for (int off = XG_LANES / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (p < mcount * n_groups && tid % XG_LANES == 0) {
      xg_s[(p / n_groups) * xg_stride + p % n_groups] = sum;
    }
  }

  int g_have = -1;
  if constexpr (MMA) {
    // each warp owns 32 columns as four n8 tiles, interleaved: column j of
    // tile t is the warp's column 4 j + t, so the four tiles' columns of a
    // lane are neighbours and one 16-byte load reads them. Lane (gq, cq)
    // holds the B codes of column gq of each tile and the C sums of row gq,
    // columns 2 cq and 2 cq + 1. The mma's k order is permuted within each
    // 16 k so that the lane's B pair (k = 2 cq, 2 cq + 1) is the codes
    // k = cq and cq + 4 of a word (or of two code rows): one dequant_bf16x2.
    const int lane = tid & 31;
    const int gq = lane >> 2;
    const int cq = lane & 3;
    const int wcol = (tid >> 5) * 32;  // the warp's first column in the block
    float acc[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
    uint32_t s2[4], ns2[4];  // bf16x2 (s, s), (-128 s, -128 s) of column gq of each tile
    for (int slot = 0; slot < n_slots; ++slot) {
      __syncthreads();  // every thread is done with the ring slot refilled now (and xg_s is in)
      issue(slot + stages - 1);
      cp_async_wait(stages - 1);  // this thread's copies of `slot` have landed
      __syncthreads();            // ... and every thread's
      const unsigned char* sl = ring + (slot % stages) * MB_SLOT;
      const float* aff = reinterpret_cast<const float*>(sl + MB_CODES);
      const uint16_t* xs = reinterpret_cast<const uint16_t*>(sl + MB_CODES + MB_AFF);
      const int r0 = r_begin + slot * SR;
      const int k0 = r0 * VPE;
      const int g0 = k0 / group_size;
      const int into = k0 - g0 * group_size;  // the slot's first k within group g0
      const int ksteps = min(SR, r_end - r0) * VPE / 16;
      for (int ks = 0; ks < ksteps; ++ks) {
        const int gi = into + 16 * ks >= group_size;  // 0 or 1: a slot spans two groups at most
        if (g0 + gi != g_have) {
          g_have = g0 + gi;
          const float xg = gq < mcount ? xg_s[gq * xg_stride + g_have - g_begin] : 0.f;
          const float4 sv = *reinterpret_cast<const float4*>(aff + gi * MB_THREADS + wcol + 4 * gq);
          const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
          const float* bias = aff + (2 + gi) * MB_THREADS + wcol + 8 * cq;
          const float4 b0 = *reinterpret_cast<const float4*>(bias);
          const float4 b1 = *reinterpret_cast<const float4*>(bias + 4);
          const float ba[4] = {b0.x, b0.y, b0.z, b0.w};
          const float bb[4] = {b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            scale_pairs(sa[t], s2[t], ns2[t]);
            acc[t][0] = fmaf(xg, ba[t], acc[t][0]);
            acc[t][1] = fmaf(xg, bb[t], acc[t][1]);
          }
        }
        uint32_t a0 = 0u, a2 = 0u;  // x (row gq) at k = cq, cq + 4 and 8 + cq, 12 + cq
        if (gq < mcount) {
          const uint16_t* xr = xs + gq * SLOT_K + 16 * ks;
          a0 = xr[cq] | ((uint32_t)xr[cq + 4] << 16);
          a2 = xr[cq + 8] | ((uint32_t)xr[cq + 12] << 16);
        }
        // codes k = cq, cq + 4 (v0) and 8 + cq, 12 + cq (v1) of the four
        // columns, each pair in bits 0-3 and 16-19
        uint32_t v0[4], v1[4];
        if constexpr (BITS == 4) {
          const uint32_t* wr = reinterpret_cast<const uint32_t*>(sl) + wcol + 4 * gq;
          const uint4 w0 = *reinterpret_cast<const uint4*>(wr + (2 * ks) * MB_THREADS);
          const uint4 w1 = *reinterpret_cast<const uint4*>(wr + (2 * ks + 1) * MB_THREADS);
          const uint32_t wa[4] = {w0.x, w0.y, w0.z, w0.w};
          const uint32_t wb[4] = {w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            v0[t] = wa[t] >> (4 * cq);
            v1[t] = wb[t] >> (4 * cq);
          }
        } else {
          const unsigned char* cr = sl + (16 * ks + cq) * MB_THREADS + wcol + 4 * gq;
          const uint32_t q0 = *reinterpret_cast<const uint32_t*>(cr);
          const uint32_t q4 = *reinterpret_cast<const uint32_t*>(cr + 4 * MB_THREADS);
          const uint32_t q8 = *reinterpret_cast<const uint32_t*>(cr + 8 * MB_THREADS);
          const uint32_t q12 = *reinterpret_cast<const uint32_t*>(cr + 12 * MB_THREADS);
#pragma unroll
          for (int t = 0; t < 4; ++t) {  // byte t of each row to bytes 0 and 2
            v0[t] = __byte_perm(q0, q4, t | ((4 + t) << 8));
            v1[t] = __byte_perm(q8, q12, t | ((4 + t) << 8));
          }
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          mma_16816(acc[t], a0, 0u, a2, 0u, dequant_bf16x2(v0[t], s2[t], ns2[t]),
                    dequant_bf16x2(v1[t], s2[t], ns2[t]));  // rows 8-15 of a: zero
        }
      }
    }
    cp_async_wait(0);
    if (gq >= mcount) return;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {  // C column 2 cq + j of tile t
        const int cn = blockIdx.x * MB_THREADS + wcol + 8 * cq + 4 * j + t;
        if (cn < n) {
          const size_t o = (size_t)(m0 + gq) * n + cn;
          if (partial != nullptr) {
            partial[(size_t)blockIdx.y * m * n + o] = acc[t][j];
          } else {
            reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(acc[t][j]);
          }
        }
      }
    }
  } else {
    // one column per thread, in registers: fp32 x (no rounding) and 8-bit
    // codes (int -> float and float -> bf16 conversions)
    float acc[MB_ROWS];
#pragma unroll
    for (int r = 0; r < MB_ROWS; ++r) acc[r] = 0.f;
    float s = 0.f;  // the group's scale, rounded to bf16 with bf16 x
    for (int slot = 0; slot < n_slots; ++slot) {
      __syncthreads();  // every thread is done with the ring slot refilled now (and xg_s is in)
      issue(slot + stages - 1);
      cp_async_wait(stages - 1);  // this thread's copies of `slot` have landed
      __syncthreads();            // ... and every thread's
      if (!active) continue;
      const unsigned char* sl = ring + (slot % stages) * MB_SLOT;
      const float* aff = reinterpret_cast<const float*>(sl + MB_CODES);
      const int r0 = r_begin + slot * SR;
      const int units = min(SR, r_end - r0) / EPU;
      const int k0 = r0 * VPE;
      const int g0 = k0 / group_size;
      int g = g0;
      int left = group_size - (k0 - g0 * group_size);  // values of group g from k0 on
      for (int u = 0; u < units; ++u) {
        if (left == 0) {
          ++g;
          left = group_size;
        }
        left -= 8;
        if (g != g_have) {
          s = aff[(g - g0) * MB_THREADS + tid];
          const float b = aff[(2 + g - g0) * MB_THREADS + tid];
#pragma unroll
          for (int r = 0; r < MB_ROWS; ++r) {
            if (r < mcount) acc[r] = fmaf(xg_s[r * xg_stride + g - g_begin], b, acc[r]);
          }
          if (BF16) s = round_bf16(s);
          g_have = g;
        }
        float wv[8];  // round_bf16(code * s) with bf16 x, code * s with fp32 x
        if constexpr (BITS == 4) {
          const uint32_t word = reinterpret_cast<const uint32_t*>(sl)[u * MB_THREADS + tid];
#pragma unroll
          for (int e = 0; e < 8; ++e) wv[e] = (float)((word >> (4 * e)) & MASK) * s;
        } else if constexpr (BITS == 8) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t word =
                reinterpret_cast<const uint32_t*>(sl)[(2 * u + h) * MB_THREADS + tid];
#pragma unroll
            for (int e = 0; e < 4; ++e) wv[4 * h + e] = (float)((word >> (8 * e)) & MASK) * s;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) wv[e] = (float)sl[(u * 8 + e) * MB_THREADS + tid] * s;
        }
        if (BF16) {
#pragma unroll
          for (int e = 0; e < 8; ++e) wv[e] = round_bf16(wv[e]);
        }
        const int kb = k0 + u * 8;
#pragma unroll
        for (int r = 0; r < MB_ROWS; ++r) {
          if (r < mcount) {
            float xv[8];
            load_x<BF16, 8>(x, (size_t)(m0 + r) * k + kb, xv);
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[r] = fmaf(xv[e], wv[e], acc[r]);
          }
        }
      }
    }
    cp_async_wait(0);
    if (!active) return;
#pragma unroll
    for (int r = 0; r < MB_ROWS; ++r) {
      if (r < mcount) {
        const size_t o = (size_t)(m0 + r) * n + col;
        if (partial != nullptr) {
          partial[(size_t)blockIdx.y * m * n + o] = acc[r];
        } else if (BF16) {
          reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(acc[r]);
        } else {
          reinterpret_cast<float*>(out)[o] = acc[r];
        }
      }
    }
  }
}

// out = the sum of the splits' fp32 partials (split 0 first), cast
template <bool BF16>
__global__ void mbt_reduce_kernel(const float* __restrict__ partial, void* __restrict__ out,
                                  int splits, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float v = 0.f;
  for (int j = 0; j < splits; ++j) v += partial[(size_t)j * count + i];
  if (BF16) {
    reinterpret_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  } else {
    reinterpret_cast<float*>(out)[i] = v;
  }
}

// K6's weights for the tiled GEMM: E = int32_t (packed words) or uint8_t
// (codes), N-contiguous (rows, Np); affines (G, Np)
template <typename E>
struct ColWords {
  static constexpr bool N_MAJOR = true;
  const E* w;
  const float* scales;
  const float* biases;
  int np;
  // element kw of columns n .. n + 3 (n a multiple of 4: one aligned load)
  __device__ __forceinline__ void word4(int n, int kw, uint32_t (&v)[4]) const {
    const E* p = w + (size_t)kw * np + n;
    if constexpr (sizeof(E) == 4) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
      const uint32_t q = __ldg(reinterpret_cast<const unsigned int*>(p));
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = (q >> (8 * j)) & 0xffu;
    }
  }
  __device__ __forceinline__ float scale(int n, int g) const {
    return __ldg(scales + (size_t)g * np + n);
  }
  __device__ __forceinline__ float bias(int n, int g) const {
    return __ldg(biases + (size_t)g * np + n);
  }
};

bool valid_layout(int m, int n, int k, int bits, int group_size, int np) {
  if (m < 1 || n < 1 || k < 1 || (bits != 0 && bits != 4 && bits != 8)) return false;
  if (group_size < 8 || group_size % 8 || k % group_size) return false;
  return np >= n && np % 16 == 0;  // every 16-byte copy of a slot row is aligned
}

template <int BITS, bool BF16>
int launch_gemv(dim3 grid, int smem, cudaStream_t s, const void* x, const void* w,
                const void* scales, const void* biases, void* out, void* partial, int m, int n,
                int k, int group_size, int np, int stages, int rows_per_split,
                int xg_stride) {
  const cudaError_t e = wmt_async::allow_smem<mbt_gemv_kernel<BITS, BF16>>(smem);
  if (e != cudaSuccess) return (int)e;
  mbt_gemv_kernel<BITS, BF16><<<grid, MB_THREADS, smem, s>>>(
      x, (const unsigned char*)w, (const float*)scales, (const float*)biases, out,
      (float*)partial, m, n, k, group_size, np, stages, rows_per_split, xg_stride);
  return 0;
}

}  // namespace

extern "C" int wmt_mbt_gemv(const void* x, const void* w, const void* scales,
                            const void* biases, void* out, void* partial, int m, int n, int k,
                            int bits, int group_size, int np, int stages, int splits,
                            int rows_per_split, int x_bf16, void* stream) {
  if (!valid_layout(m, n, k, bits, group_size, np)) {
    return (int)cudaErrorInvalidValue;
  }
  const int vpe = bits ? 32 / bits : 1;
  const int slot_rows = MB_CODES / (MB_THREADS * (bits ? 4 : 1));
  const int slot_k = slot_rows * vpe;
  // a slot's codes touch at most two groups, whose affines ride with them
  if (2 * group_size < slot_k || (group_size % slot_k && slot_k % group_size)) {
    return (int)cudaErrorInvalidValue;
  }
  if (stages < 1 || stages > MB_MAX_STAGES || splits < 1 || rows_per_split < 1 ||
      rows_per_split % slot_rows || (long long)splits * rows_per_split < k / vpe ||
      (splits > 1) != (partial != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((n + MB_THREADS - 1) / MB_THREADS, splits, (m + MB_ROWS - 1) / MB_ROWS);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  // groups a split touches, a partial one at each end included
  const int xg_stride = rows_per_split * vpe / group_size + 2;
  const int smem = stages * MB_SLOT + MB_ROWS * xg_stride * 4;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  int rc;
#define WMT_MBT_GEMV(B, F)                                                                 \
  launch_gemv<B, F>(grid, smem, s, x, w, scales, biases, out, partial, m, n, k, group_size, \
                    np, stages, rows_per_split, xg_stride)
  if (bits == 4) {
    rc = x_bf16 ? WMT_MBT_GEMV(4, true) : WMT_MBT_GEMV(4, false);
  } else if (bits == 8) {
    rc = x_bf16 ? WMT_MBT_GEMV(8, true) : WMT_MBT_GEMV(8, false);
  } else {
    rc = x_bf16 ? WMT_MBT_GEMV(0, true) : WMT_MBT_GEMV(0, false);
  }
#undef WMT_MBT_GEMV
  if (rc != 0) return rc;
  if (splits > 1) {
    const int count = m * n;
    const int threads = 256;
    if (x_bf16) {
      mbt_reduce_kernel<true><<<(count + threads - 1) / threads, threads, 0, s>>>(
          (const float*)partial, out, splits, count);
    } else {
      mbt_reduce_kernel<false><<<(count + threads - 1) / threads, threads, 0, s>>>(
          (const float*)partial, out, splits, count);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int wmt_mbt_gemm(const void* x, const void* xg, const void* w, const void* scales,
                            const void* biases, void* out, int m, int n, int k, int bits,
                            int group_size, int np, void* stream) {
  if (!valid_layout(m, n, k, bits, group_size, np) || k % BK) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
  const float* xgf = (const float*)xg;
  const float* sc = (const float*)scales;
  const float* bi = (const float*)biases;
  __nv_bfloat16* o = (__nv_bfloat16*)out;
  if (bits == 0) {
    const ColWords<uint8_t> cw{(const uint8_t*)w, sc, bi, np};
    quant_gemm_kernel<8, 1><<<grid, GM_THREADS, 0, s>>>(xb, xgf, cw, o, m, n, k, group_size);
  } else {
    const ColWords<int32_t> cw{(const int32_t*)w, sc, bi, np};
    if (bits == 4) {
      quant_gemm_kernel<4, 8><<<grid, GM_THREADS, 0, s>>>(xb, xgf, cw, o, m, n, k, group_size);
    } else {
      quant_gemm_kernel<8, 4><<<grid, GM_THREADS, 0, s>>>(xb, xgf, cw, o, m, n, k, group_size);
    }
  }
  return (int)cudaGetLastError();
}
