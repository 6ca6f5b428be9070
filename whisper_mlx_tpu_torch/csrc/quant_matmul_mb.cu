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
// 0.091 ms at 3.35 TB/s) should, but the dequantization's instruction
// stream did. Kernels cut short on throwaway copies (PERF.md, section 6) showed
// the first form bound by its loop, not bytes: without loads it took 78 %
// of its full time, its stream alone ran at 1.9-2.5 TB/s. The redesign's
// drafts were bound the same way, by what their SASS showed: generic loads
// (an aligned pointer had lost the shared address space), a division by
// the runtime group size every k step, and x as the mma's A with eight zero
// rows, rebuilt in moved registers, for four mma a k step.
//
// Design, three routes:
// - mbt_gemv_mma_kernel (bf16 x, 4-bit codes packed or one a byte, groups
//   of 32-256 k dividing a stage; at most 8 rows a launch group): one
//   launch a linear. A block owns 128 columns and a run of ring stages (16
//   KB of codes: 256 k packed, 128 k codes-resident, and each group's
//   scales and biases, once); a thread-block cluster of 1-8 blocks splits
//   K (the wrapper's plan, ops/quant_matmul_mb.py:mbt_gemv_plan) and the
//   blocks sum their fp32 partials in block order through distributed
//   shared memory: no second kernel, no partial tensor. One producer lane
//   keeps TMA boxes in a ring of `stages` (the layout's `depth`, capped so
//   that two blocks share an SM) with full and empty mbarriers, fencing the
//   async proxy after each empty wait. Packed words come as four 32-column
//   boxes, 128-byte swizzled, one a consumer warp. Eight consumer warps:
//   4 column groups of 32 x the two halves of a stage's k, summed at the
//   end. A lane takes whole words of its four neighbouring columns (k = 16
//   cq .. 16 cq + 15 of each 64 k, nibble pairs (s, s + 4) in k step s:
//   shifts by constants), one lop3 and one bf16x2 FMA a pair of codes
//   (round_bf16(c * round_bf16(s)), exact before its one rounding), and
//   mma.sync m16n8k16 with the weights as A (two columns a tile: no zero
//   rows) and x as B (its rows 0-7, the mma's n). The group size is a
//   template parameter, so a group's scales and bias are found by shifts.
//   x comes into shared memory once, in the mma's permuted k order, with
//   its sums over each group (the bias term xg * b).
// - mbt_gemv_kernel (fp32 x, 8-bit codes, other group sizes; at most 8
//   rows or K not a multiple of 64, and every call whose group size no
//   other route takes): the first form without its tensor-core branch, one
//   column a thread in SIMT through a cp.async ring of `depth` slots, each
//   slot carrying the scales and biases of every group its codes touch
//   (ceil(slot_k / g) + 1 of them, so any group of a multiple of 8 k runs:
//   neither has to divide the other); a second kernel sums its K splits.
// - quant_gemm_kernel (bf16 x, M > 8; quant_tile.cuh, shared with K5): the
//   Hopper tiled core; ColTiles below reads the N-major words (a box of 8
//   or 16 word rows x a block's columns, a lane's two neighbouring columns
//   in one 8-byte load) or codes (128-byte-swizzled boxes of 64 k x 128
//   columns) and the (G, Np) affines, 16 bytes a copy.
// Measured on the card at M = 1 (PERF.md): the tensor-core GEMV 0.175 ms
// over the four linears packed (the first form 0.29), 1.7-2.6 TB/s; the
// large linears now near their stream's rate, the small ones on a block's
// fixed cost.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

#include "quant_tile.cuh"
#include "sm90_async.cuh"

namespace {

using namespace wmt_quant;
using namespace wmt_async;

constexpr int MB_THREADS = 256;  // columns of a block
constexpr int MB_CODES = 8192;   // code bytes of one ring slot
constexpr int MB_ROWS = 8;       // rows of x per block (grid.z walks the rest)
constexpr int MB_MAX_STAGES = 8;
constexpr int MB_MAX_GROUPS = 64 / 8 + 1;  // groups a slot's 64 k of codes touch at most

// bytes of one ring slot: the codes, then the scales and the biases of its
// `ng` groups (256 columns each)
__host__ __device__ constexpr int mb_slot(int ng) { return MB_CODES + 2 * ng * MB_THREADS * 4; }
constexpr int XG_LANES = 8;    // threads that sum one (row, group) of x

// BITS 4 or 8: packed words; 0: int8 codes, one per byte
template <int BITS, bool BF16>
__global__ void __launch_bounds__(MB_THREADS, 4)  // four blocks per SM: at most 64 registers
mbt_gemv_kernel(const void* __restrict__ x, const unsigned char* __restrict__ w,
                const float* __restrict__ scales, const float* __restrict__ biases,
                void* __restrict__ out, float* __restrict__ partial, int m, int n, int k,
                int group_size, int np, int stages, int rows_per_split, int xg_stride, int ng) {
  constexpr int ESZ = BITS ? 4 : 1;            // bytes of one stored element
  constexpr int VPE = BITS ? 32 / BITS : 1;    // k values of one stored element
  constexpr int EPU = 8 / VPE;                 // stored rows of 8 k values
  constexpr int ROW_BYTES = MB_THREADS * ESZ;  // one slot row: 256 columns
  constexpr int SR = MB_CODES / ROW_BYTES;     // slot rows: 8 packed, 32 codes
  constexpr int CPR = ROW_BYTES / 16;          // 16-byte copies of a slot row
  constexpr int ROW_STEP = MB_THREADS / CPR;
  constexpr int COPIES = SR / ROW_STEP;        // code copies of a thread per slot
  constexpr uint32_t MASK = BITS ? (1u << BITS) - 1u : 0xffu;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  const int slot_bytes = mb_slot(ng);
  float* xg_s = reinterpret_cast<float*>(smem + stages * slot_bytes);  // (MB_ROWS, xg_stride)

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
  auto issue = [&](int slot) {  // copy the split's slot `slot` into the ring
    if (slot < n_slots) {
      unsigned char* dst = ring + (slot % stages) * slot_bytes;
      const int r0 = r_begin + slot * SR;
#pragma unroll
      for (int j = 0; j < COPIES; ++j) {
        const int rr = crow + j * ROW_STEP;
        const bool ok = cvalid && r0 + rr < r_end;
        const unsigned char* src = ok ? w + ((long long)(r0 + rr) * np + ccol) * ESZ : w;
        cp_async16(dst + rr * ROW_BYTES + cc * 16, src, ok);
      }
      // affine copies: 4 columns of the scales (which < ng: of the slot's
      // group which) or of the biases (which - ng)
      for (int c = tid; c < 2 * ng * (MB_THREADS / 4); c += MB_THREADS) {
        const int which = c / (MB_THREADS / 4);
        const int acol = blockIdx.x * MB_THREADS + (c % (MB_THREADS / 4)) * 4;
        const int g = r0 * VPE / group_size + (which < ng ? which : which - ng);
        const bool ok = g < groups && acol < np;
        cp_async16(dst + MB_CODES + which * MB_THREADS * 4 + (c % (MB_THREADS / 4)) * 16,
                   ok ? (which < ng ? scales : biases) + (size_t)g * np + acol : scales, ok);
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

  // one column per thread, in registers: fp32 x (no rounding), 8-bit
  // codes and group sizes the tensor-core route does not take (int -> float
  // and float -> bf16 conversions)
  int g_have = -1;
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
    const unsigned char* sl = ring + (slot % stages) * slot_bytes;
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
        const float b = aff[(ng + g - g0) * MB_THREADS + tid];
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

// ---------------------------------------------------------------------------
// GEMV on tensor cores: bf16 x, 4-bit codes (packed words or one a byte), at
// most 8 rows a launch group; one launch a linear
// ---------------------------------------------------------------------------

constexpr int TV_COLS = 128;                   // columns of a block
constexpr int TV_CONSUMERS = 256;              // 8 warps: 4 column groups x 2 halves of k
constexpr int TV_THREADS = TV_CONSUMERS + 32;  // and one producer warp
constexpr int TV_CODES = 16384;                // code bytes of a stage: one TMA box
constexpr int TV_ROWS = 8;                     // rows of x (the mma's rows 0-7)
constexpr int TV_MAX_STAGES = 8;
constexpr int TV_MAX_CLUSTER = 8;              // the portable cluster size
constexpr int TV_RED = TV_COLS * TV_ROWS + TV_MAX_CLUSTER;  // fp32 slots of the cluster sum

// stored rows and k of a stage: 32 rows of packed words (256 k) or 128 rows
// of codes (128 k), 128 columns either way
__host__ __device__ constexpr int tv_srows(bool packed) {
  return packed ? TV_CODES / (TV_COLS * 4) : TV_CODES / TV_COLS;
}
__host__ __device__ constexpr int tv_sk(bool packed) { return packed ? tv_srows(true) * 8 : tv_srows(false); }

// x's row in shared memory, 2 kcap bytes and this pad: each quarter warp's
// 16-byte reads (lanes gq = 0, 1 x cq = 0-3) then span all 32 banks
__host__ __device__ constexpr int tv_xpad(bool packed) { return packed ? 16 : 64; }

// Shared memory, from a 1024-byte boundary: the ring (a stage: codes | the
// scales | the biases of its groups, 128 columns each) | x permuted, rows x
// (2 kcap + 64) bytes | x's sums over each 32 k | over each group | the
// partial outputs the other blocks of the cluster push here | full and
// empty barriers.
struct TvSmem {
  int aff, stage, xs, xsum, xg, red, bars, bytes;
  __host__ __device__ TvSmem(bool packed, int group_size, int stages, int rows, int kcap) {
    aff = tv_sk(packed) / group_size * TV_COLS * 4;
    stage = (TV_CODES + 2 * aff + 1023) & ~1023;
    xs = stages * stage;
    xsum = xs + rows * (2 * kcap + tv_xpad(packed));
    xg = xsum + ((rows * (kcap / 32) * 4 + 15) & ~15);
    red = xg + ((rows * (kcap / group_size) * 4 + 15) & ~15);
    bars = red + TV_RED * 4;
    bytes = bars + 2 * stages * 8 + 1024;  // and the room to align the base
  }
};

__device__ __forceinline__ void consumers_sync() {  // the consumer warps alone
  asm volatile("bar.sync 1, %0;\n" ::"n"(TV_CONSUMERS) : "memory");
}

// quant_tile.cuh's dequant_bf16x2 with its mask-and-or in one lop3 (the
// 0x4300 pair held in a register): bf16x2 round_bf16(c * s) of the codes in
// bits 0-3 and 16-19 of v
__device__ __forceinline__ uint32_t dq2(uint32_t v, uint32_t s2, uint32_t ns2) {
  uint32_t pair, w;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(pair) : "r"(v), "n"(0x000F000F), "r"(0x43004300));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(w) : "r"(pair), "r"(s2), "r"(ns2));
  return w;
}

// One k step of a warp's 32 columns as two m16n8k16 tiles: A the weights,
// dequantized (tile T's row gq is column 4 gq + 2 T, row gq + 8 column 4 gq
// + 2 T + 1: a lane's four columns are neighbours), B x (column gq is x's
// row gq; b0, b1 its pairs at the step's k), C (column, x row) in fp32.
// v0[t], v1[t]: codes of column 4 gq + t at B's k pairs, in bits 0-3 and
// 16-19; s2, ns2: their scales as bf16x2 pairs.
__device__ __forceinline__ void mma_step(float (&acc)[2][4], const uint32_t (&v0)[4],
                                         const uint32_t (&v1)[4], const uint32_t (&s2)[4],
                                         const uint32_t (&ns2)[4], uint32_t b0, uint32_t b1) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    mma_16816(acc[t], dq2(v0[2 * t], s2[2 * t], ns2[2 * t]),
              dq2(v0[2 * t + 1], s2[2 * t + 1], ns2[2 * t + 1]),
              dq2(v1[2 * t], s2[2 * t], ns2[2 * t]), dq2(v1[2 * t + 1], s2[2 * t + 1], ns2[2 * t + 1]),
              b0, b1);
  }
}

// Block (rank r of a cluster of C along grid.x, column block blockIdx.y,
// row group blockIdx.z) owns 128 columns and the stages [r * S / C, (r + 1)
// * S / C) of the stored rows. Warp 8's first lane keeps TMA boxes (the
// stage's codes, 128 columns x 32 word rows or 128 code rows, the latter
// 128-byte swizzled, and the rows of its groups' scales and biases: each
// group's once) in a ring of `stages` with full and empty barriers. Warps
// 0-7 consume: warp w owns the 32 columns 32 (w % 4) .. as four n8 tiles,
// interleaved (column j of tile t is the warp's column 4 j + t, so a lane's
// four columns are neighbours: one 16-byte load of words), over the half
// w / 4 of each stage's k steps.
template <bool PACKED, int GS>
__global__ void __launch_bounds__(TV_THREADS, 2)  // two blocks an SM: at most 113 registers
mbt_gemv_mma_kernel(const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap smap,
                    const __grid_constant__ CUtensorMap bmap, const __nv_bfloat16* __restrict__ x,
                    __nv_bfloat16* __restrict__ out, int m, int n, int k, int stages, int kcap) {
  constexpr int SROWS = tv_srows(PACKED);
  constexpr int SK = tv_sk(PACKED);
  extern __shared__ unsigned char smem_raw[];
  // aligned by an offset from the array, so the compiler keeps the
  // shared address space (LDS, not generic loads)
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n0 = blockIdx.y * TV_COLS;
  const int m0 = blockIdx.z * TV_ROWS;
  if (csize > 1) cluster_arrive_relaxed();  // waited before the push to other blocks
  const int mr = min(TV_ROWS, m - m0);
  const int nst = (k + SK - 1) / SK;
  const int s_begin = rank * nst / csize;
  const int ns = (rank + 1) * nst / csize - s_begin;
  const int kb = s_begin * SK;
  const int ke = min(k, kb + ns * SK);
  constexpr int GPS = SK / GS;  // groups of a stage
  const TvSmem lay(PACKED, GS, stages, min(TV_ROWS, m), kcap);
  const int xrow = 2 * kcap + tv_xpad(PACKED);
  unsigned char* xs = smem + lay.xs;
  float* xsum = reinterpret_cast<float*>(smem + lay.xsum);
  float* xg = reinterpret_cast<float*>(smem + lay.xg);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + stages;
  const bool producer = warp == TV_CONSUMERS / 32;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], TV_CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();
  auto issue = [&](int i) {  // stage i of the block's range into ring slot i % stages
    const int s = i % stages;
    unsigned char* st = smem + s * lay.stage;
    mbar_expect_tx(&full[s], TV_CODES + 2 * lay.aff);
    if constexpr (PACKED) {  // four 32-column boxes, one a consumer warp's columns
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        tma_load_2d(st + j * 4096, &wmap, &full[s], n0 + 32 * j, (s_begin + i) * SROWS);
      }
    } else {
      tma_load_2d(st, &wmap, &full[s], n0, (s_begin + i) * SROWS);
    }
    tma_load_2d(st + TV_CODES, &smap, &full[s], n0, (s_begin + i) * GPS);
    tma_load_2d(st + TV_CODES + lay.aff, &bmap, &full[s], n0, (s_begin + i) * GPS);
  };
  if (producer && lane == 0) {
    for (int i = 0; i < min(stages, ns); ++i) issue(i);  // the stream starts now
  }
  __syncwarp();

  // While the first stages land: x's rows over the block's k range into
  // shared memory as the mma's A in the permuted k order below (packed:
  // each 64 k as lane cq's 32 bytes, (x[16 cq + s], x[16 cq + s + 4]),
  // (x[16 cq + 8 + s], x[16 cq + 12 + s]) for s = 0-3; codes: each 32 k as
  // lane cq's 16 bytes (x[cq], x[cq + 4]), (x[8 + cq], x[12 + cq]) and the
  // same 16 on), zeros past k; their sums over each 32 k, then over each
  // group, in a fixed order.
  const int nb = ns * SK / 32;
  const int bstride = kcap / 32;
  for (int p = tid; p < mr * nb; p += TV_THREADS) {
    const int r = p / nb;
    const int b = p % nb;
    const int kk = kb + 32 * b;
    uint32_t v[32];
    float sum = 0.f;
    if (kk < ke) {
      const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * k + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint4 u = __ldg(src + j);
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[8 * j + 2 * e] = w[e] & 0xffffu;
          v[8 * j + 2 * e + 1] = w[e] >> 16;
        }
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) sum += bf16_bits_to_float(v[e]);
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) v[e] = 0u;
    }
    uint4* dst = reinterpret_cast<uint4*>(xs + r * xrow + b * 64);
    if constexpr (PACKED) {  // lane cq = 2 (b % 2) + j of the 64 k: 16 j + (s, s + 4), (8 + s, 12 + s)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint32_t* u = v + 16 * j;
        dst[2 * j] = make_uint4(u[0] | (u[4] << 16), u[8] | (u[12] << 16), u[1] | (u[5] << 16),
                                u[9] | (u[13] << 16));
        dst[2 * j + 1] = make_uint4(u[2] | (u[6] << 16), u[10] | (u[14] << 16),
                                    u[3] | (u[7] << 16), u[11] | (u[15] << 16));
      }
    } else {  // lane cq: (c, c + 4), (c + 8, c + 12) and the same 16 on
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        dst[c] = make_uint4(v[c] | (v[c + 4] << 16), v[c + 8] | (v[c + 12] << 16),
                            v[c + 16] | (v[c + 20] << 16), v[c + 24] | (v[c + 28] << 16));
      }
    }
    xsum[r * bstride + b] = sum;
  }
  __syncthreads();
  const int ng = (ke - kb) / GS;
  const int gstride = kcap / GS;
  for (int p = tid; p < mr * ng; p += TV_THREADS) {
    const int r = p / ng;
    const int g = p % ng;
    float sum = 0.f;
#pragma unroll
    for (int b = 0; b < GS / 32; ++b) sum += xsum[r * bstride + g * (GS / 32) + b];
    xg[r * gstride + g] = sum;
  }
  __syncthreads();

  // Lane (gq, cq) holds A (x row gq; rows 8-15 are zero) at k = cq, cq + 4
  // and 8 + cq, 12 + cq of each 16 k step, the B codes of column gq of each
  // tile at the same k (the mma's k order permuted within the step, the
  // same for A and B: cq, cq + 4 are nibbles cq and cq + 4 of a word, or
  // bytes of rows cq and cq + 4), and the C sums of x row gq, columns 2 cq
  // and 2 cq + 1. A warp's half of a stage is walked a group (or, past
  // HALF_K, the part of one) at a time: the four columns' scales once, the
  // group's bias as xg * b once (by the warp whose half starts it), then its
  // k steps unrolled, even and odd steps into two chains of sums.
  constexpr int HALF_K = SK / 2;
  constexpr int CHUNK = GS < HALF_K ? GS : HALF_K;  // k of a warp's group (part)
  const int gq = lane >> 2;
  const int cq = lane & 3;
  const int wcol = (warp & 3) * 32;
  const int half = warp >> 2;
  float acc[2][2][4] = {};  // [chain][tile][C register]
  // a group's bias as xg * b: columns 4 gq .. 4 gq + 3 from b4, x rows 2 cq
  // and 2 cq + 1 from xgp (row 0's sum of x over the group)
  auto add_bias = [&](float (&a)[2][4], const float* b4, const float* xgp) {
    const float4 b = *reinterpret_cast<const float4*>(b4);
    const float bv[4] = {b.x, b.y, b.z, b.w};
    const float x0 = 2 * cq < mr ? xgp[2 * cq * gstride] : 0.f;
    const float x1 = 2 * cq + 1 < mr ? xgp[(2 * cq + 1) * gstride] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i / 4][i % 4] = fmaf(i & 1 ? x1 : x0, bv[i / 2], a[i / 4][i % 4]);
  };
  if (producer) {
    if (lane == 0) {
      for (int i = stages; i < ns; ++i) {
        mbar_wait(&empty[i % stages], (i / stages - 1) & 1);
        fence_proxy_async();  // the consumers' reads of the stage before TMA's writes
        issue(i);
      }
    }
    __syncwarp();
  } else if constexpr (PACKED) {
    // Lane (gq, cq) takes, of each 64 k, the words 2 cq and 2 cq + 1 of its
    // four columns (k = 16 cq .. 16 cq + 15, one group): one 16-byte read
    // each from the warp's 32-column box (piece gq ^ (row % 8): no bank
    // conflicts), and nibbles (s, s + 4) of both in k step s = 0-3.
    const bool xin = gq < mr;
    const unsigned char* wbox0 = smem + (warp & 3) * 4096;  // + the stage's offset
    for (int i = 0; i < ns; ++i) {
      const int s = i % stages;
      mbar_wait(&full[s], (i / stages) & 1);
      const unsigned char* st = smem + s * lay.stage;
      const unsigned char* wbox = wbox0 + s * lay.stage;
      const float* sc = reinterpret_cast<const float*>(st + TV_CODES);
      const float* bi = reinterpret_cast<const float*>(st + TV_CODES + lay.aff);
#pragma unroll
      for (int u = 0; u < HALF_K / 64; ++u) {
        const int ko = half * HALF_K + 64 * u;  // the unit's first k in the stage
        const int kk = kb + i * SK + ko;
        if (kk >= ke) break;  // past the tensor's end (K a multiple of 64 here)
        uint32_t s2[4], ns2[4];  // the lane's group: k = ko + 16 cq
        const float4 sv = *reinterpret_cast<const float4*>(
            sc + ((ko + 16 * cq) / GS) * TV_COLS + wcol + 4 * gq);
        scale_pairs(sv.x, s2[0], ns2[0]);
        scale_pairs(sv.y, s2[1], ns2[1]);
        scale_pairs(sv.z, s2[2], ns2[2]);
        scale_pairs(sv.w, s2[3], ns2[3]);
        if (GS < 64 || ko % GS == 0) {  // the groups that start in the unit: their bias, once
#pragma unroll
          for (int g = 0; g < (GS < 64 ? 64 / GS : 1); ++g) {
            if (kk + g * GS < ke) add_bias(acc[0], bi + (ko / GS + g) * TV_COLS + wcol + 4 * gq,
                                           xg + (kk - kb) / GS + g);
          }
        }
        const int ro = ko / 8 + 2 * cq;  // the word rows 2 cq, 2 cq + 1 of the unit
        const uint4 wa = *reinterpret_cast<const uint4*>(wbox + ro * 128 + ((gq ^ (ro & 7)) << 4));
        const uint4 wb = *reinterpret_cast<const uint4*>(wbox + (ro + 1) * 128 +
                                                         ((gq ^ ((ro + 1) & 7)) << 4));
        uint4 xa = make_uint4(0u, 0u, 0u, 0u);
        uint4 xb = xa;
        if (xin) {  // x row gq: the mma's B column gq
          const unsigned char* xp = xs + gq * xrow + (kk - kb) * 2 + 32 * cq;
          xa = *reinterpret_cast<const uint4*>(xp);
          xb = *reinterpret_cast<const uint4*>(xp + 16);
        }
        const uint32_t xw[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
        const uint32_t va[4] = {wa.x, wa.y, wa.z, wa.w};
        const uint32_t vb[4] = {wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // k step q of the unit
          uint32_t v0[4], v1[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            v0[t] = va[t] >> (4 * q);
            v1[t] = vb[t] >> (4 * q);
          }
          mma_step(acc[q & 1], v0, v1, s2, ns2, xw[2 * q], xw[2 * q + 1]);
        }
      }
      __syncwarp();  // every lane's reads of the stage are done (the mma took them)
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  } else {
    const bool xin = gq < mr;
    for (int i = 0; i < ns; ++i) {
      const int s = i % stages;
      mbar_wait(&full[s], (i / stages) & 1);
      const unsigned char* st = smem + s * lay.stage;
      const float* sc = reinterpret_cast<const float*>(st + TV_CODES);
      const float* bi = reinterpret_cast<const float*>(st + TV_CODES + lay.aff);
#pragma unroll
      for (int c = 0; c < HALF_K / CHUNK; ++c) {
        const int ko = half * HALF_K + c * CHUNK;  // the chunk's first k in the stage
        const int kk = kb + i * SK + ko;
        if (kk >= ke) break;  // past the tensor's end: whole chunks, K a multiple of GS
        uint32_t s2[4], ns2[4];
        const float4 sv = *reinterpret_cast<const float4*>(sc + (ko / GS) * TV_COLS + wcol + 4 * gq);
        scale_pairs(sv.x, s2[0], ns2[0]);
        scale_pairs(sv.y, s2[1], ns2[1]);
        scale_pairs(sv.z, s2[2], ns2[2]);
        scale_pairs(sv.w, s2[3], ns2[3]);
        if (ko % GS == 0) {
          add_bias(acc[0], bi + (ko / GS) * TV_COLS + wcol + 4 * gq, xg + (kk - kb) / GS);
        }
#pragma unroll
        for (int p = 0; p < CHUNK / 32; ++p) {  // pairs of k steps
          uint4 xv = make_uint4(0u, 0u, 0u, 0u);
          if (xin) xv = *reinterpret_cast<const uint4*>(xs + gq * xrow + (kk - kb + 32 * p) * 2 + 16 * cq);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int step = ko / 16 + 2 * p + e;  // the k step in the stage
            uint32_t v0[4], v1[4];  // codes k = cq, cq + 4 (v0) and 8 + cq, 12 + cq (v1)
            // code row r, byte column c sits at piece (c / 16) ^ (r % 8) of its 128 bytes
            const int col = wcol + 4 * gq;
            auto word = [&](int r) {
              return *reinterpret_cast<const uint32_t*>(
                  st + r * TV_COLS + (((col >> 4) ^ (r & 7)) << 4) + (col & 15));
            };
            const int r = 16 * step + cq;
            const uint32_t q0 = word(r), q4 = word(r + 4), q8 = word(r + 8), q12 = word(r + 12);
#pragma unroll
            for (int t = 0; t < 4; ++t) {  // byte t of each row to bytes 0 and 2
              v0[t] = __byte_perm(q0, q4, t | ((4 + t) << 8));
              v1[t] = __byte_perm(q8, q12, t | ((4 + t) << 8));
            }
            mma_step(acc[e], v0, v1, s2, ns2, e ? xv.z : xv.x, e ? xv.w : xv.y);
          }
        }
      }
      __syncwarp();  // every lane's reads of the stage are done (the mma took them)
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }
  if (!producer) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[0][i / 4][i % 4] += acc[1][i / 4][i % 4];  // even steps first
    // the two halves' sums: half 1's through the ring, free now, into half 0's
    consumers_sync();
    float* ex = reinterpret_cast<float*>(smem) + ((warp & 3) * 32 + lane) * 8;
    if (half == 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i) ex[i] = acc[0][i / 4][i % 4];
    }
    consumers_sync();
    if (half == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[0][i / 4][i % 4] += ex[i];
    }
  }

  // acc[0][T][c]: column wcol + 4 gq + 2 T + c / 2, x row 2 cq + c % 2.
  // With a cluster, output e = column * mr + row belongs to block e % C,
  // which sums the partials every block pushed into its slots, in block
  // order.
  const bool owns = !producer && half == 0;
  if (csize == 1) {
    if (owns) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = 2 * cq + (i & 1);
        const int col = n0 + wcol + 4 * gq + i / 2;
        if (row < mr && col < n) {
          out[(size_t)(m0 + row) * n + col] = __float2bfloat16_rn(acc[0][i / 4][i % 4]);
        }
      }
    }
    return;
  }
  const int slots = (TV_COLS * mr + csize - 1) / csize;
  cluster_wait();  // every block of the cluster has started
  if (owns) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = 2 * cq + (i & 1);
      if (row < mr) {
        const int e = (wcol + 4 * gq + i / 2) * mr + row;
        cluster.map_shared_rank(red, e % csize)[rank * slots + e / csize] = acc[0][i / 4][i % 4];
      }
    }
  }
  cluster.sync();
  for (int slot = tid; slot < slots; slot += TV_THREADS) {
    const int e = slot * csize + rank;
    const int col = n0 + e / mr;
    if (e < TV_COLS * mr && col < n) {
      float sum = 0.f;
      for (int src = 0; src < csize; ++src) sum += red[src * slots + slot];  // block 0 first
      out[(size_t)(m0 + e % mr) * n + col] = __float2bfloat16_rn(sum);
    }
  }
}

// K6's weights for the tiled core (quant_tile.cuh). BITS 4, 8: packed words
// (K / per_word, Np) int32, a stage's box 64 / per_word word rows x a block's
// columns; BITS 0: codes (K, Np) one a byte, boxes of 64 rows x 128 columns,
// 128-byte swizzled (a lane's rows 2t, 2t + 1, 2t + 8, 2t + 9 then fall in
// different banks). Affines (G, Np) fp32, neighbouring columns adjacent.
template <int BITS>
struct ColTiles {
  static constexpr int PW = BITS ? 32 / BITS : 1;  // codes a stored element
  static constexpr int WBYTES = BITS == 4 ? 32 : 64;
  static constexpr bool EIGHT = BITS == 8;
  CUtensorMap wmap;
  const void* w;
  const float* scales;
  const float* biases;
  int k, np;

  __host__ __device__ static constexpr int aff_floats(int cols, int gs) {
    return tiled::gps_of(gs) * cols;
  }
  bool prepare(int cols, int gs) {
    if (BITS) {
      return tensor_map_2d(&wmap, w, CU_TENSOR_MAP_DATA_TYPE_INT32, k / PW, np, 4LL * np,
                           tiled::SK / PW, cols, CU_TENSOR_MAP_SWIZZLE_NONE);
    }
    return tensor_map_2d(&wmap, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, k, np, np, tiled::SK, 128,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  }
  template <int COLS>
  __device__ __forceinline__ int tx(int gs) const { return COLS * WBYTES; }
  // (gps, COLS): the stage's group gi, column c
  template <int COLS>
  __device__ __forceinline__ int aff(int c, int g0, int gi) const { return gi * COLS + c; }
  // the codes by TMA (lane 0); the stage's scales and biases, zeros past
  // Np, 16 bytes a cp.async
  template <int COLS>
  __device__ __forceinline__ void load(unsigned char* dst, float* sc, float* bi, uint64_t* bar,
                                       int n0, int k0, int gs, int lane) const {
    if (lane == 0) {
      if constexpr (BITS != 0) {
        tma_load_2d(dst, &wmap, bar, n0, k0 / PW);
      } else {
#pragma unroll
        for (int b = 0; b < COLS / 128; ++b) {
          tma_load_2d(dst + b * tiled::SK * 128, &wmap, bar, n0 + 128 * b, k0);
        }
      }
    }
    const int g0 = k0 / gs;
    const int per = tiled::gps_of(gs) * COLS / 4;  // 16-byte pieces of one array
    for (int p = lane; p < 2 * per; p += 32) {
      const int which = p >= per;
      const int r = p - which * per;
      const int gi = r / (COLS / 4), c = (r % (COLS / 4)) * 4;
      const bool ok = n0 + c < np;  // Np is a multiple of 16
      const float* src = which ? biases : scales;
      cp_async16((which ? bi : sc) + gi * COLS + c, ok ? src + (size_t)(g0 + gi) * np + n0 + c : src,
                 ok);
    }
  }
  // k step kk's A fragment of columns c0, c0 + 1: word rows 2 kk, 2 kk + 1
  // (4-bit) or 4 kk + t / 2, 4 kk + 2 + t / 2 (8-bit), both columns in one
  // load; codes rows 16 kk + 2t, + 1, + 8, + 9, both columns' bytes a load
  template <int COLS>
  __device__ __forceinline__ void dequant(const unsigned char* wt, int c0, int kk, int t,
                                          const uint32_t (&sp)[4], uint32_t (&a)[4]) const {
    if constexpr (BITS == 4) {
      const uint2 r0 = *reinterpret_cast<const uint2*>(wt + (2 * kk) * COLS * 4 + c0 * 4);
      const uint2 r1 = *reinterpret_cast<const uint2*>(wt + (2 * kk + 1) * COLS * 4 + c0 * 4);
      a[0] = tiled::dq_pair(tiled::nibble_pair(r0.x, t), sp[0], sp[1]);
      a[1] = tiled::dq_pair(tiled::nibble_pair(r0.y, t), sp[2], sp[3]);
      a[2] = tiled::dq_pair(tiled::nibble_pair(r1.x, t), sp[0], sp[1]);
      a[3] = tiled::dq_pair(tiled::nibble_pair(r1.y, t), sp[2], sp[3]);
    } else if constexpr (BITS == 8) {
      const unsigned char* p = wt + (4 * kk + (t >> 1)) * COLS * 4 + c0 * 4;
      const uint2 r0 = *reinterpret_cast<const uint2*>(p);
      const uint2 r1 = *reinterpret_cast<const uint2*>(p + 2 * COLS * 4);
      const int b = 2 * (t & 1);
      a[0] = tiled::dq_bytes(r0.x, b, sp[0], sp[1]);
      a[1] = tiled::dq_bytes(r0.y, b, sp[2], sp[3]);
      a[2] = tiled::dq_bytes(r1.x, b, sp[0], sp[1]);
      a[3] = tiled::dq_bytes(r1.y, b, sp[2], sp[3]);
    } else {
      const unsigned char* box = wt + (c0 >> 7) * (tiled::SK * 128);
      const int bc = c0 & 127;
      auto pair = [&](int r) -> uint32_t {  // the two columns' codes at row r, swizzled
        return *reinterpret_cast<const uint16_t*>(box + r * 128 + (((bc >> 4) ^ (r & 7)) << 4) +
                                                  (bc & 15));
      };
      const int r = 16 * kk + 2 * t;
      const uint32_t v0 = pair(r), v1 = pair(r + 1), v8 = pair(r + 8), v9 = pair(r + 9);
      a[0] = tiled::dq_pair(__byte_perm(v0, v1, 0x0400), sp[0], sp[1]);  // column c0: bytes 0
      a[1] = tiled::dq_pair(__byte_perm(v0, v1, 0x0501), sp[2], sp[3]);  // column c0 + 1: bytes 1
      a[2] = tiled::dq_pair(__byte_perm(v8, v9, 0x0400), sp[0], sp[1]);
      a[3] = tiled::dq_pair(__byte_perm(v8, v9, 0x0501), sp[2], sp[3]);
    }
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
                int xg_stride, int ng) {
  const cudaError_t e = wmt_async::allow_smem<mbt_gemv_kernel<BITS, BF16>>(smem);
  if (e != cudaSuccess) return (int)e;
  mbt_gemv_kernel<BITS, BF16><<<grid, MB_THREADS, smem, s>>>(
      x, (const unsigned char*)w, (const float*)scales, (const float*)biases, out,
      (float*)partial, m, n, k, group_size, np, stages, rows_per_split, xg_stride, ng);
  return 0;
}

// The tensor-core GEMV's launch: K split across a cluster of `cluster`
// blocks (the wrapper's plan, ops/quant_matmul_mb.py:mbt_gemv_plan),
// `stages` ring stages; tensor maps of the codes, scales and biases.
template <bool PACKED, int GS>
int launch_gemv_mma(const void* x, const void* w, const void* scales, const void* biases,
                    void* out, int m, int n, int k, int np, int stages, int cluster,
                    cudaStream_t s) {
  constexpr int SK = tv_sk(PACKED);
  const int nst = (k + SK - 1) / SK;
  if (k % GS || stages < 1 || stages > TV_MAX_STAGES || cluster < 1 ||
      cluster > TV_MAX_CLUSTER || cluster > nst) {
    return (int)cudaErrorInvalidValue;
  }
  const int kcap = (nst + cluster - 1) / cluster * SK;
  const TvSmem lay(PACKED, GS, stages, std::min(TV_ROWS, m), kcap);
  const dim3 grid(cluster, (n + TV_COLS - 1) / TV_COLS, (m + TV_ROWS - 1) / TV_ROWS);
  if (lay.bytes > 227 * 1024 || grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap wm, sm, bm;
  const bool ok =
      (PACKED ? tensor_map_2d(&wm, w, CU_TENSOR_MAP_DATA_TYPE_INT32, k / 8, np, 4LL * np,
                              tv_srows(true), TV_COLS / 4, CU_TENSOR_MAP_SWIZZLE_128B)
              : tensor_map_2d(&wm, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, k, np, np, tv_srows(false),
                              TV_COLS, CU_TENSOR_MAP_SWIZZLE_128B)) &&
      tensor_map_2d(&sm, scales, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, k / GS, np, 4LL * np, SK / GS,
                    TV_COLS, CU_TENSOR_MAP_SWIZZLE_NONE) &&
      tensor_map_2d(&bm, biases, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, k / GS, np, 4LL * np, SK / GS,
                    TV_COLS, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)launch_cluster<mbt_gemv_mma_kernel<PACKED, GS>>(
      grid, TV_THREADS, lay.bytes, cluster, s, wm, sm, bm, (const __nv_bfloat16*)x,
      (__nv_bfloat16*)out, m, n, k, stages, kcap);
}

}  // namespace

extern "C" int wmt_mbt_gemv_mma(const void* x, const void* w, const void* scales,
                                const void* biases, void* out, int m, int n, int k, int codes,
                                int group_size, int np, int stages, int cluster, void* stream) {
  if (!valid_layout(m, n, k, codes ? 0 : 4, group_size, np)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define WMT_MBT_MMA(P, G) \
  launch_gemv_mma<P, G>(x, w, scales, biases, out, m, n, k, np, stages, cluster, s)
  switch (codes ? -group_size : group_size) {  // groups of 32 k or more that divide a stage
    case 32: return WMT_MBT_MMA(true, 32);
    case 64: return WMT_MBT_MMA(true, 64);
    case 128: return WMT_MBT_MMA(true, 128);
    case 256: return WMT_MBT_MMA(true, 256);
    case -32: return WMT_MBT_MMA(false, 32);
    case -64: return WMT_MBT_MMA(false, 64);
    case -128: return WMT_MBT_MMA(false, 128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef WMT_MBT_MMA
}

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
  // a slot's codes (slot_k k from a multiple of slot_k) touch at most
  // ceil(slot_k / g) + 1 groups, whose affines ride with them
  const int ng = (slot_k + group_size - 1) / group_size + 1;
  if (ng > MB_MAX_GROUPS) return (int)cudaErrorInvalidValue;
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
  const int smem = stages * mb_slot(ng) + MB_ROWS * xg_stride * 4;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  int rc;
#define WMT_MBT_GEMV(B, F)                                                                 \
  launch_gemv<B, F>(grid, smem, s, x, w, scales, biases, out, partial, m, n, k, group_size, \
                    np, stages, rows_per_split, xg_stride, ng)
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

extern "C" int wmt_mbt_gemm(const void* x, const void* w, const void* scales, const void* biases,
                            void* out, int m, int n, int k, int bits, int group_size, int np,
                            int nt, int cluster, int stages, void* stream) {
  if (!valid_layout(m, n, k, bits, group_size, np)) return (int)cudaErrorInvalidValue;
  auto run = [&](auto f) {
    f.w = w;
    f.scales = (const float*)scales;
    f.biases = (const float*)biases;
    f.k = k;
    f.np = np;
    return tiled::launch(x, f, out, m, n, k, group_size, nt, cluster, stages,
                         (cudaStream_t)stream);
  };
  switch (bits) {
    case 4: return run(ColTiles<4>{});
    case 8: return run(ColTiles<8>{});
    default: return run(ColTiles<0>{});
  }
}
