// W8A8 matmul (kernel K7) for Hopper (sm_90a).
//
// Replaces: whisper_mlx_tpu/ops/quant_a8.py:a8_matmul (_a8_kernel), the
// Pallas TPU kernel that streams per-channel int8 codes through a DMA ring
// and multiplies them on the MXU with per-row dynamically quantized
// activations (WTPU_QWEN_A8).
//
// For x (M, K) and codes c (N, K) int8 with one fp32 scale s_n per output
// channel (the port stores the codes N-major: a channel's k values are
// contiguous):
//   sx_m   = max(max_k |x_mk|, 1e-8) / 127                   (fp32)
//   q_mk   = clip(round_half_even(x_mk / sx_m), -127, 127)   (true division)
//   out_mn = (float(sum_k q_mk c_nk) * s_n) * sx_m          (int32 sum, fp32)
// and out is cast to x's dtype. Every step is exact or rounds where the
// plain version (ops/quant_a8.py:a8_matmul_plain) rounds: bit-equal to it.
//
// What bounds it on the H100: at decode the bytes of the int8 code stream
// (one Qwen3-32B layer's four linears and the head: 1.27 GB, 0.378 ms at
// 3.35 TB/s). The integer dot is cheap (one m16n8k32 mma per 512 codes of
// a warp) and there is no per-value dequantization, so what it takes is
// bytes in flight on every SM from the first cycle, one launch, and a grid
// that fills the card. Measured (PERF.md): 0.46 ms over the five at M = 1,
// 90 % of the bound on the head, 50-70 % on the small linears, where a
// block's fixed cost (x's passes, the cluster's sums, the first bytes'
// latency) is a fifth of its time.
//
// Design:
// - a8_gemv_kernel (M <= 8 a launch group; more rows when K is not a
//   multiple of 64): one launch a linear. A block owns 128 channels and a
//   run of 256-k chunks; a thread-block cluster of 1-8 blocks splits K
//   (the wrapper's plan, ops/quant_a8.py:a8_gemv_plan: the fewest waves of
//   two blocks an SM times the chunks a block streams). One producer lane
//   keeps TMA boxes in a ring of 2-8 stages of 128 channels x 256 k (two
//   boxes side by side, 128 k each, 128-byte swizzle: 256 contiguous bytes
//   of a row a stage) with full and empty mbarriers, issuing the first
//   before anything else, and fencing the async proxy after each empty
//   wait (without fence.proxy.async a box can land over a stage that
//   generic loads have not yet read: measured, at two stages). Meanwhile
//   the block reads its rows of x from L2: the absmax of its k range, the
//   cluster's absmax through distributed shared memory (the whole row),
//   the scale, and its k range quantized into shared memory, so xq and sx
//   never go to device memory. Eight consumer warps of 16 channels take
//   mma.sync m16n8k32 s8 x s8 -> s32 (A the codes, read conflict-free
//   through the swizzle; B x's rows, zero past M), an exact sum. The
//   blocks of a cluster push their int32 partials to the output's owner
//   through distributed shared memory, which sums them in block order.
// - a8_quantize_kernel, then a8_gemm_kernel (M > 8, K a multiple of 64):
//   x's rows quantized into device memory by a block each (16-byte loads
//   held in registers, the row's absmax, true division, round half to
//   even), then the Hopper tiled GEMM. What bounds it: a prefill's 128-512
//   rows are a GEMM near the ridge (one Qwen3-32B layer's four linears at
//   384 rows: 374.5 GOP, 0.189 ms at 1,979 TOP/s, against 0.15 ms of
//   codes). The design:
//   * both operands K-major through a TMA ring: the codes (N, K) are
//     wgmma's A (64 channels a consumer warpgroup, one or two 64-channel
//     tiles), x's quantized rows its N (16, 32, 64 or 128 a block), both
//     read by wgmma.m64nNk32.s32.s8.s8 from shared memory in the 128-byte
//     swizzle TMA writes (8-bit wgmma takes no transpose, and neither
//     operand needs one);
//   * stages of 128 k, one swizzle row a channel and a row of x, in a ring
//     of 2-8 with full and empty mbarriers; the producer warpgroup (24
//     registers; a lone producer warp's setmaxnreg never returned,
//     attn_tile.cuh) has one lane issue the boxes, fencing the async
//     proxy after each empty wait; K's tail past a multiple of 128 is
//     zero-filled by TMA;
//   * blocks of 128 channels x 16, 32 or 64 rows up to 128 rows, 256 x 128
//     above, one an SM with the deepest ring that fits (8 stages below 128
//     rows: bytes in flight gave more than a second block an SM); where the
//     grid would not fill the card, K split across a cluster of 1, 2, 4 or
//     8 blocks below 128 rows a block (the wrapper's plan,
//     ops/quant_a8.py:a8_tiled_plan), whose int32 partials are summed in
//     block order through distributed shared memory (each block owning a
//     chunk of every thread's accumulators, stored as the unsplit epilogue
//     stores them): integer sums, exact, so the result does not depend on
//     the split;
//   * the epilogue in registers, (float(acc) * s_n) * sx_m and the cast:
//     the plain version's roundings, so the route is bit-equal to it.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

#include "attn_tile.cuh"
#include "sm90_async.cuh"

namespace {

using namespace wmt_async;

constexpr unsigned FULL = 0xffffffffu;

template <bool BF16>
__device__ __forceinline__ float x_at(const void* x, size_t i) {
  if constexpr (BF16) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(x)[i]);
  } else {
    return reinterpret_cast<const float*>(x)[i];
  }
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
// GEMV: few rows, one launch: the activations' quantization fused, the code
// stream through a TMA ring, split-K reduced across a thread-block cluster
// ---------------------------------------------------------------------------

constexpr int FV_CH = 128;                    // output channels of a block
constexpr int FV_BOX = 128;                   // k of one TMA box: a 128-byte swizzle row
constexpr int FV_BOXES = 2;                   // boxes side by side along k in a stage
constexpr int FV_KC = FV_BOX * FV_BOXES;      // k of one ring stage
constexpr int FV_STAGE = FV_CH * FV_KC;       // code bytes of one stage
constexpr int FV_CONSUMERS = 256;             // 8 warps, 16 channels each
constexpr int FV_THREADS = FV_CONSUMERS + 32; // and one producer warp
constexpr int FV_ROWS = 8;                    // rows of x a block (the mma's n)
constexpr int FV_MAX_STAGES = 8;
constexpr int FV_MAX_CLUSTER = 8;             // the portable cluster size
constexpr int FV_XPAD = 16;                   // x row stride = 16 mod 128: no bank conflicts
constexpr int FV_RED = FV_CH * FV_ROWS + FV_MAX_CLUSTER;  // int32 slots of the cluster sum

// Shared memory, from a 1024-byte boundary (the 128-byte swizzle's period):
// the ring | the block's k range of x quantized, rows x (kcap + FV_XPAD)
// int8 | the rows' absmax and scale (fp32) | the partial sums the other
// blocks of the cluster push here | full and empty barriers.
struct FvSmem {
  int xq, amax, red, bars, bytes;
  __host__ __device__ FvSmem(int stages, int rows, int kcap) {
    xq = stages * FV_STAGE;
    amax = xq + rows * (kcap + FV_XPAD);
    red = amax + 2 * FV_ROWS * 4;
    bars = red + FV_RED * 4;
    bytes = bars + 2 * stages * 8 + 1024;  // and the room to align the base
  }
};

// c += a @ b for one m16n8k32 tile, s8 in, s32 accumulate (a0 row g k
// 4t..4t+3, a1 row g + 8, a2 row g k 16+4t.., a3 row g + 8 k 16+4t..;
// b0 k 4t.. column g, b1 k 16+4t..; c0, c1 row g columns 2t, 2t+1, c2, c3
// row g + 8; g = lane / 4, t = lane % 4)
__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16 bytes of x (8 bf16 or 4 fp32 values) from element i, and as floats
template <bool BF16>
__device__ __forceinline__ uint4 x_raw(const void* x, size_t i) {
  return __ldg(reinterpret_cast<const uint4*>(reinterpret_cast<const char*>(x) +
                                              i * (BF16 ? 2 : 4)));
}

template <bool BF16>
__device__ __forceinline__ void x_unpack(uint4 u, float (&v)[BF16 ? 8 : 4]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (BF16) {
      v[2 * e] = __uint_as_float(w[e] << 16);
      v[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    } else {
      v[e] = __uint_as_float(w[e]);
    }
  }
}

// the int8 codes of one vector of x (8 or 4 bytes) into shared memory
template <bool BF16>
__device__ __forceinline__ void store_codes(int8_t* dst, const uint32_t (&packed)[BF16 ? 2 : 1]) {
  if constexpr (BF16) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[1]);
  } else {
    *reinterpret_cast<uint32_t*>(dst) = packed[0];
  }
}

// Block (rank r of a cluster of C along grid.x, column block blockIdx.y,
// row group blockIdx.z) owns FV_CH channels and the k chunks [r * chunks
// / C, (r + 1) * chunks / C) of FV_KC. Warps 0-7 consume, warp 8's first
// lane produces: it keeps `stages` stages (FV_BOXES TMA boxes of 128
// channels x 128 k each, 128-byte swizzle) in flight, each completing on
// its stage's full barrier; a consumer warp arrives on the stage's empty
// barrier when done with it.
template <bool BF16>
__global__ void __launch_bounds__(FV_THREADS, 2)  // two blocks an SM: at most 113 registers
a8_gemv_kernel(const __grid_constant__ CUtensorMap cmap, const void* __restrict__ x,
               const float* __restrict__ scale, void* __restrict__ out, int m, int n, int k,
               int stages, int kcap) {
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
  const int n0 = blockIdx.y * FV_CH;
  const int m0 = blockIdx.z * FV_ROWS;
  const int mr = min(FV_ROWS, m - m0);
  const int chunks = (k + FV_KC - 1) / FV_KC;
  const int c_begin = rank * chunks / csize;
  const int nc = (rank + 1) * chunks / csize - c_begin;
  const int kb = c_begin * FV_KC;
  const int ke = min(k, kb + nc * FV_KC);
  const FvSmem lay(stages, min(FV_ROWS, m), kcap);
  const int xrow = kcap + FV_XPAD;
  int8_t* xq = reinterpret_cast<int8_t*>(smem + lay.xq);
  float* amax = reinterpret_cast<float*>(smem + lay.amax);
  float* sx = amax + FV_ROWS;
  int* red = reinterpret_cast<int*>(smem + lay.red);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + stages;
  const bool producer = warp == FV_CONSUMERS / 32;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], FV_CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  if (tid < FV_ROWS) amax[tid] = 0.f;
  __syncthreads();
  auto issue = [&](int i) {  // chunk i of the block's range into stage i % stages
    const int s = i % stages;
    mbar_expect_tx(&full[s], FV_STAGE);
#pragma unroll
    for (int b = 0; b < FV_BOXES; ++b) {
      tma_load_2d(smem + s * FV_STAGE + b * FV_CH * FV_BOX, &cmap, &full[s],
                  (c_begin + i) * FV_KC + b * FV_BOX, n0);
    }
  };
  if (producer && lane == 0) {
    for (int i = 0; i < min(stages, nc); ++i) issue(i);  // the stream starts now
  }
  __syncwarp();

  // x, while the first stages land: the absmax of each row over the
  // block's k range (fmax is exact in any order), then over the cluster's
  // (the whole row) through distributed shared memory, the scale, and the
  // range quantized into shared memory. A thread's 16-byte vectors of x are
  // loaded XB at a time (their L2 reads in flight together) and kept in
  // registers for the quantization when they all fit there.
  constexpr int VEC = BF16 ? 8 : 4;
  constexpr int XB = 8;
  const int nv = (ke - kb) / VEC;  // vectors of a row in the range
  const int total = mr * nv;
  const int per = (total + FV_THREADS - 1) / FV_THREADS;  // vectors of a thread
  uint4 held[XB];
  auto load_batch = [&](int b0) {
#pragma unroll
    for (int j = 0; j < XB; ++j) {
      const int p = tid + (b0 + j) * FV_THREADS;
      if (p < total) held[j] = x_raw<BF16>(x, (size_t)(m0 + p / nv) * k + kb + (p % nv) * VEC);
    }
  };
  for (int b0 = 0; b0 < per; b0 += XB) {
    load_batch(b0);
#pragma unroll
    for (int j = 0; j < XB; ++j) {
      const int p = tid + (b0 + j) * FV_THREADS;
      if (p < total) {
        float v[VEC];
        x_unpack<BF16>(held[j], v);
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) a = fmaxf(a, fabsf(v[e]));
        atomicMax(reinterpret_cast<int*>(amax + p / nv), __float_as_int(a));  // >= 0: as ints
      }
    }
  }
  cluster.sync();
  if (tid < mr) {
    float a = 0.f;
    for (int src = 0; src < csize; ++src) a = fmaxf(a, *cluster.map_shared_rank(amax + tid, src));
    sx[tid] = __fdiv_rn(fmaxf(a, 1e-8f), 127.f);
  }
  __syncthreads();
  for (int b0 = 0; b0 < per; b0 += XB) {
    if (per > XB) load_batch(b0);
#pragma unroll
    for (int j = 0; j < XB; ++j) {
      const int p = tid + (b0 + j) * FV_THREADS;
      if (p < total) {
        const int r = p / nv;
        float v[VEC];
        x_unpack<BF16>(held[j], v);
        uint32_t packed[VEC / 4] = {};
#pragma unroll
        for (int e = 0; e < VEC; ++e) {  // true division, round half to even
          const float q = fminf(fmaxf(rintf(__fdiv_rn(v[e], sx[r])), -127.f), 127.f);
          packed[e / 4] |= ((uint32_t)(int)q & 0xffu) << (8 * (e % 4));
        }
        store_codes<BF16>(xq + r * xrow + (p % nv) * VEC, packed);
      }
    }
  }
  const int tail = (nc * FV_KC - (ke - kb)) / VEC;  // zeros past k to the whole chunks
  for (int p = tid; p < mr * tail; p += FV_THREADS) {
    const uint32_t zero[VEC / 4] = {};
    store_codes<BF16>(xq + (p / tail) * xrow + (ke - kb) + (p % tail) * VEC, zero);
  }
  __syncthreads();

  // Warp w owns channels 16 w .. 16 w + 15: the mma's A rows. Lane (gq, cq)
  // reads k 32 cq .. 32 cq + 31 of each 128-k box of its channels c0 = 16 w +
  // gq and c1 = c0 + 8 (two 16-byte pieces each, found through the
  // swizzle: piece j of a row r sits at j ^ (r % 8)) and of x row gq (B),
  // and takes them in four m16n8k32 steps of 8 k; the mma's k order is a
  // permutation of the chunk's, the same for A and B, so the sum is exact.
  int acc[4] = {0, 0, 0, 0};  // (c0, rows 2 cq, 2 cq + 1), (c1, the same)
  const int gq = lane >> 2;
  const int cq = lane & 3;
  const int c0 = warp * 16 + gq;
  if (producer) {
    if (lane == 0) {
      for (int i = stages; i < nc; ++i) {
        mbar_wait(&empty[i % stages], (i / stages - 1) & 1);
        fence_proxy_async();  // the consumers' reads of the stage before TMA's writes
        issue(i);
      }
    }
    __syncwarp();
  } else {
    const int p0 = ((2 * cq) ^ gq) * 16;  // c0 % 8 == c1 % 8 == gq
    const int p1 = ((2 * cq + 1) ^ gq) * 16;
    const bool xin = gq < mr;
    for (int i = 0; i < nc; ++i) {
      const int s = i % stages;
      mbar_wait(&full[s], (i / stages) & 1);
#pragma unroll
      for (int b = 0; b < FV_BOXES; ++b) {
        const unsigned char* st = smem + s * FV_STAGE + b * FV_CH * FV_BOX;
        const uint4 a0 = *reinterpret_cast<const uint4*>(st + c0 * FV_BOX + p0);
        const uint4 a1 = *reinterpret_cast<const uint4*>(st + c0 * FV_BOX + p1);
        const uint4 b0 = *reinterpret_cast<const uint4*>(st + (c0 + 8) * FV_BOX + p0);
        const uint4 b1 = *reinterpret_cast<const uint4*>(st + (c0 + 8) * FV_BOX + p1);
        uint4 xa = make_uint4(0u, 0u, 0u, 0u);
        uint4 xb = xa;
        if (xin) {
          const int8_t* xr = xq + gq * xrow + i * FV_KC + b * FV_BOX + 32 * cq;
          xa = *reinterpret_cast<const uint4*>(xr);
          xb = *reinterpret_cast<const uint4*>(xr + 16);
        }
        mma_s8(acc, a0.x, b0.x, a0.y, b0.y, xa.x, xa.y);
        mma_s8(acc, a0.z, b0.z, a0.w, b0.w, xa.z, xa.w);
        mma_s8(acc, a1.x, b1.x, a1.y, b1.y, xb.x, xb.y);
        mma_s8(acc, a1.z, b1.z, a1.w, b1.w, xb.z, xb.w);
      }
      __syncwarp();  // every lane's reads of the stage are done (the mma took them)
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }

  // out = (float(sum) * s_n) * sx_m. With a cluster, output e = channel *
  // mr + row belongs to block e % C, which sums the int32 partials that
  // every block pushed into its slots (exact in any order; block 0 first).
  auto store = [&](int ch, int r, int sum) {
    if (n0 + ch < n) {
      store_out<BF16>(out, (size_t)(m0 + r) * n + n0 + ch, sum, __ldg(scale + n0 + ch), sx[r]);
    }
  };
  if (csize == 1) {
    if (!producer) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 2 * cq + (i & 1);
        if (r < mr) store(c0 + (i >> 1) * 8, r, acc[i]);
      }
    }
    return;
  }
  const int slots = (FV_CH * mr + csize - 1) / csize;
  if (!producer) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 2 * cq + (i & 1);
      if (r < mr) {
        const int e = (c0 + (i >> 1) * 8) * mr + r;
        cluster.map_shared_rank(red, e % csize)[rank * slots + e / csize] = acc[i];
      }
    }
  }
  cluster.sync();
  for (int slot = tid; slot < slots; slot += FV_THREADS) {
    const int e = slot * csize + rank;
    if (e < FV_CH * mr) {
      int sum = 0;
      for (int src = 0; src < csize; ++src) sum += red[src * slots + slot];
      store(e / mr, e % mr, sum);
    }
  }
}

// ---------------------------------------------------------------------------
// More rows: x quantized by a launch of its own, then the tiled GEMM on
// wgmma s8 from a TMA ring
// ---------------------------------------------------------------------------

constexpr int Q_THREADS = 256;
constexpr int Q_HELD = 4;  // 16-byte vectors a thread keeps in registers (a bf16 row of 8192)

// Row blockIdx.x of x quantized: xq = clip(rint(x / sx), +-127), sx =
// max(amax, 1e-8) / 127 (true divisions). A thread's 16-byte vectors are
// all loaded before the row's absmax is reduced (one round trip to memory)
// and kept in registers for the quantization; a longer row's rest is
// loaded again (from L1 or L2). k a multiple of 8 (bf16) or 4 (fp32).
template <bool BF16>
__global__ void __launch_bounds__(Q_THREADS)
a8_quantize_kernel(const void* __restrict__ x, int8_t* __restrict__ xq,
                   float* __restrict__ sx, int k) {
  constexpr int VEC = BF16 ? 8 : 4;
  __shared__ float part[Q_THREADS / 32];
  const size_t row = (size_t)blockIdx.x * k;
  const int nv = k / VEC;
  const int tid = threadIdx.x;
  uint4 held[Q_HELD];
  float amax = 0.f;
  auto absmax = [&](uint4 u) {
    float v[VEC];
    x_unpack<BF16>(u, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) amax = fmaxf(amax, fabsf(v[e]));
  };
#pragma unroll
  for (int j = 0; j < Q_HELD; ++j) {
    const int p = tid + Q_THREADS * j;
    if (p < nv) held[j] = x_raw<BF16>(x, row + (size_t)p * VEC);
  }
#pragma unroll
  for (int j = 0; j < Q_HELD; ++j) {
    if (tid + Q_THREADS * j < nv) absmax(held[j]);
  }
  for (int p = tid + Q_THREADS * Q_HELD; p < nv; p += Q_THREADS) {
    absmax(x_raw<BF16>(x, row + (size_t)p * VEC));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(FULL, amax, off));
  if ((tid & 31) == 0) part[tid >> 5] = amax;
  __syncthreads();
  amax = 0.f;
#pragma unroll
  for (int j = 0; j < Q_THREADS / 32; ++j) amax = fmaxf(amax, part[j]);
  const float scale = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
  auto quantize = [&](uint4 u, int p) {
    float v[VEC];
    x_unpack<BF16>(u, v);
    uint32_t packed[VEC / 4] = {};
#pragma unroll
    for (int e = 0; e < VEC; ++e) {  // true division, round half to even
      const float q = fminf(fmaxf(rintf(__fdiv_rn(v[e], scale)), -127.f), 127.f);
      packed[e / 4] |= ((uint32_t)(int)q & 0xffu) << (8 * (e % 4));
    }
    store_codes<BF16>(xq + row + (size_t)p * VEC, packed);
  };
#pragma unroll
  for (int j = 0; j < Q_HELD; ++j) {
    if (tid + Q_THREADS * j < nv) quantize(held[j], tid + Q_THREADS * j);
  }
  for (int p = tid + Q_THREADS * Q_HELD; p < nv; p += Q_THREADS) {
    quantize(x_raw<BF16>(x, row + (size_t)p * VEC), p);
  }
  if (tid == 0) sx[blockIdx.x] = scale;
}

namespace tiled8 {

constexpr int THREADS = 384;    // two consumer warpgroups and one producer warpgroup
constexpr int CONSUMERS = 256;
constexpr int SK = 128;         // k of a ring stage: one 128-byte swizzle row
constexpr int MAX_STAGES = 8;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
constexpr int SMEM_LIMIT = 227 * 1024;
// setmaxnreg at 128 rows: 2 x 128 x 240 + 128 x 24 = 64,512, the 168 a
// thread ptxas gives a block of 384 at entry
constexpr int CONSUMER_REGS = 240;
constexpr int PRODUCER_REGS = 24;

// 64-channel A tiles of a consumer warpgroup, and a block's channels
__host__ __device__ constexpr int tiles_of(int nt) { return nt == 128 ? 2 : 1; }
__host__ __device__ constexpr int cols_of(int nt) { return 128 * tiles_of(nt); }

// Shared memory (mirrored by ops/quant_a8.py:_tiled_smem): `stages` slots
// of [codes cols x 128 B | x nt x 128 B], each a multiple of 1024 bytes
// (the swizzle's period), then the full and empty barriers; 1024 bytes
// more to align the base.
struct Layout {
  int x, slot, bars, bytes;
  __host__ __device__ Layout(int nt, int stages) {
    x = cols_of(nt) * SK;
    slot = x + nt * SK;
    bars = stages * slot;
    bytes = bars + 2 * stages * 8 + 1024;
  }
};

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma's issue or wait.
template <int N>
__device__ __forceinline__ void fence_iregs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D[64 x N] += A[64 x 32] . B[32 x N], s8 x s8 -> s32, A (the codes) and B
// (x's rows) K-major in shared memory; generated, one asm statement a shape.
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_s8<16>(int (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// (float(acc) * s_n) * s_m into out[row, col], in x's dtype
template <bool BF16>
__device__ __forceinline__ void put(void* out, int m, int n, int row, int col, int acc, float s_n,
                                    float s_m) {
  if (row < m && col < n) store_out<BF16>(out, (size_t)row * n + col, acc, s_n, s_m);
}

// Block (rank r of a cluster of C along grid.x, row block blockIdx.y of NT
// rows, column block blockIdx.z of cols_of(NT) channels; the row blocks of
// a column block run next to each other, so its codes come from device
// memory once) takes K's 128-k stages [r * U / C, (r + 1) * U / C).
template <int NT, bool BF16>
__global__ void __launch_bounds__(THREADS, 1)
a8_gemm_kernel(const __grid_constant__ CUtensorMap cmap, const __grid_constant__ CUtensorMap xmap,
               const float* __restrict__ sx, const float* __restrict__ scale,
               void* __restrict__ out, int m, int n, int k, int stages) {
  constexpr int TILES = tiles_of(NT);
  constexpr int COLS = cols_of(NT);
  constexpr int NA = NT / 2;  // accumulator registers of one 64-channel tile
  extern __shared__ unsigned char smem_raw[];
  // aligned by an offset from the array, so the compiler keeps the shared
  // address space
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const Layout L(NT, stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + stages;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // the warp's index, known warp-uniform to the compiler (a role branch on
  // threadIdx alone made ptxas serialize wgmma in the tiled core)
  const int warp_id = __shfl_sync(FULL, tid >> 5, 0);
  const int m0 = blockIdx.y * NT;
  const int n0 = blockIdx.z * COLS;
  const int units = (k + SK - 1) / SK;
  const int u0 = rank * units / csize;
  const int ns = (rank + 1) * units / csize - u0;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp_id >= CONSUMERS / 32) {
    if constexpr (NT == 128) attn::regs_dec<PRODUCER_REGS>();
    if (warp_id == CONSUMERS / 32 && lane == 0) {
      // the ring's loads, `stages` ahead of the consumers
      int slot = 0;
      uint32_t phase = 0;
      for (int i = 0; i < ns; ++i) {
        if (i >= stages) {
          mbar_wait(&empty[slot], phase ^ 1u);
          fence_proxy_async();  // the consumers' reads of the slot before TMA's writes
        }
        unsigned char* st = smem + slot * L.slot;
        const int k0 = (u0 + i) * SK;
        mbar_expect_tx(&full[slot], (COLS + NT) * SK);
        tma_load_2d(st, &cmap, &full[slot], k0, n0);
        tma_load_2d(st + L.x, &xmap, &full[slot], k0, m0);
        if (++slot == stages) {
          slot = 0;
          phase ^= 1u;
        }
      }
    }
    if (csize > 1) {  // the consumers' cluster sum
      cluster.sync();
      cluster.sync();
    }
    return;
  }

  if constexpr (NT == 128) attn::regs_inc<CONSUMER_REGS>();
  const int wg = warp_id >> 2;
  const int wt = tid & 127;
  const int warp = warp_id & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  int acc[TILES][NA];
#pragma unroll
  for (int tau = 0; tau < TILES; ++tau) {
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[tau][i] = 0;
  }
  // Each stage: four k steps of 32 a tile in one commit group; the group
  // before it completes (wait_group 1) before its slot is released, so one
  // group runs while the next stage's wait and issue go on.
  int slot = 0, held = -1;
  uint32_t phase = 0;
  for (int i = 0; i < ns; ++i) {
    mbar_wait(&full[slot], phase);
    const unsigned char* st = smem + slot * L.slot;
    attn::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SK / 32; ++kk) {
      const uint64_t db = attn::sw128_desc(st + L.x + 32 * kk, 16, 1024);
#pragma unroll
      for (int tau = 0; tau < TILES; ++tau) {
        wgmma_s8<NT>(acc[tau],
                     attn::sw128_desc(st + (wg * TILES + tau) * 64 * SK + 32 * kk, 16, 1024), db);
      }
    }
    attn::wgmma_commit();
    wgmma_wait<1>();
    if (held >= 0) mbar_arrive(&empty[held]);  // every consumer thread: no divergent branch
    held = slot;
    if (++slot == stages) {
      slot = 0;
      phase ^= 1u;
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int tau = 0; tau < TILES; ++tau) fence_iregs(acc[tau]);

  // acc[tau][4j + e]: channel (wg * TILES + tau) * 64 + 16 warp + g + 8 (e >> 1),
  // row 8 j + 2 t + (e & 1)
  if (csize == 1) {
#pragma unroll
    for (int tau = 0; tau < TILES; ++tau) {
      const int c0 = n0 + (wg * TILES + tau) * 64 + 16 * warp + g;
      const float s0 = c0 < n ? __ldg(scale + c0) : 0.f;
      const float s1 = c0 + 8 < n ? __ldg(scale + c0 + 8) : 0.f;
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        const int r = m0 + 8 * j + 2 * t;
        const float x0 = r < m ? __ldg(sx + r) : 0.f;
        const float x1 = r + 1 < m ? __ldg(sx + r + 1) : 0.f;
        put<BF16>(out, m, n, r, c0, acc[tau][4 * j], s0, x0);
        put<BF16>(out, m, n, r + 1, c0, acc[tau][4 * j + 1], s0, x1);
        put<BF16>(out, m, n, r, c0 + 8, acc[tau][4 * j + 2], s1, x0);
        put<BF16>(out, m, n, r + 1, c0 + 8, acc[tau][4 * j + 3], s1, x1);
      }
    }
    return;
  }
  // The cluster's sum through the ring (every block is past its main loop
  // after the first barrier): each consumer thread's V accumulators (v =
  // tau * NA + i) fall into C chunks of cs = V / C; block b owns chunk b of
  // every thread and receives it from the same thread of every block, four
  // neighbouring values in one 16-byte store where a chunk holds whole
  // fours: red4[(src * cs / 4 + v % cs / 4) * CONSUMERS + thread] (a warp's
  // stores contiguous: no bank conflicts), else one value a store:
  // red[(src * cs + v % cs) * CONSUMERS + thread]. It sums them in block
  // order and stores as the epilogue above does, coalesced alike.
  constexpr int V = TILES * NA;
  int* red = reinterpret_cast<int*>(smem);
  const int cs = V / csize;  // a power of two: V is one, csize 2, 4 or 8
  const bool quad = cs % 4 == 0;
  cluster.sync();
#pragma unroll
  for (int tau = 0; tau < TILES; ++tau) {
#pragma unroll
    for (int i = 0; i < NA; i += 4) {
      const int v = tau * NA + i;
      if (quad) {
        reinterpret_cast<int4*>(cluster.map_shared_rank(red, v / cs))
            [(rank * (cs / 4) + v % cs / 4) * CONSUMERS + tid] =
            make_int4(acc[tau][i], acc[tau][i + 1], acc[tau][i + 2], acc[tau][i + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          cluster.map_shared_rank(red, (v + e) / cs)[(rank * cs + (v + e) % cs) * CONSUMERS + tid] =
              acc[tau][i + e];
        }
      }
    }
  }
  cluster.sync();
#pragma unroll
  for (int tau = 0; tau < TILES; ++tau) {
    const int c0 = n0 + (wg * TILES + tau) * 64 + 16 * warp + g;
#pragma unroll
    for (int i = 0; i < NA; i += 4) {
      const int v = tau * NA + i;
      int sum[4] = {0, 0, 0, 0};
      bool mine[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[e] = (v + e) / cs == rank;
      if (quad) {
        if (mine[0]) {
          for (int src = 0; src < csize; ++src) {  // block 0 first
            const int4 p = reinterpret_cast<const int4*>(red)[(src * (cs / 4) + v % cs / 4) *
                                                               CONSUMERS + tid];
            sum[0] += p.x;
            sum[1] += p.y;
            sum[2] += p.z;
            sum[3] += p.w;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (mine[e]) {
            for (int src = 0; src < csize; ++src) {
              sum[e] += red[(src * cs + (v + e) % cs) * CONSUMERS + tid];
            }
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + 8 * (((i + e) >> 1) & 1);
        const int row = m0 + 8 * ((i + e) >> 2) + 2 * t + ((i + e) & 1);
        if (mine[e] && row < m && col < n) {
          store_out<BF16>(out, (size_t)row * n + col, sum[e], __ldg(scale + col), __ldg(sx + row));
        }
      }
    }
  }
}

// The tiled GEMM's launch: nt, cluster and stages from the wrapper's plan
// (ops/quant_a8.py:a8_tiled_plan), checked here.
template <bool BF16>
int launch(const void* xq, const void* sx, const void* codes, const void* scale, void* out, int m,
           int n, int k, int nt, int cluster, int stages, cudaStream_t s) {
  if (m < 1 || n < 1 || k < 64 || k % 64) return (int)cudaErrorInvalidValue;
  if (nt != 16 && nt != 32 && nt != 64 && nt != 128) return (int)cudaErrorInvalidValue;
  const int units = (k + SK - 1) / SK;
  if (cluster < 1 || cluster > MAX_CLUSTER || cluster > units || stages < 2 ||
      stages > MAX_STAGES) {
    return (int)cudaErrorInvalidValue;
  }
  const int cols = cols_of(nt);
  const Layout L(nt, stages);
  const long long red = cluster > 1 ? 4LL * cols * nt : 0;  // every block's chunks
  const dim3 grid(cluster, (m + nt - 1) / nt, (n + cols - 1) / cols);
  if (L.bytes > SMEM_LIMIT || red > (long long)L.bars || grid.y > 65535 || grid.z > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap cmap, xmap;
  if (!tensor_map_2d(&cmap, codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, n, k, k, cols, SK,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map_2d(&xmap, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, m, k, k, nt, SK,
                     CU_TENSOR_MAP_SWIZZLE_128B)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* sxf = (const float*)sx;
  const float* sc = (const float*)scale;
#define WMT_A8_TILED(NT)                                                                   \
  launch_cluster<a8_gemm_kernel<NT, BF16>>(grid, THREADS, L.bytes, cluster, s, cmap, xmap, \
                                           sxf, sc, out, m, n, k, stages)
  switch (nt) {
    case 16: return (int)WMT_A8_TILED(16);
    case 32: return (int)WMT_A8_TILED(32);
    case 64: return (int)WMT_A8_TILED(64);
    default: return (int)WMT_A8_TILED(128);
  }
#undef WMT_A8_TILED
}

}  // namespace tiled8

// The fused GEMV's launch: a cluster of `cluster` blocks splits K (the
// wrapper's plan: ops/quant_a8.py:a8_gemv_plan), `stages` ring stages.
int launch_gemv(const void* x, const void* codes, const void* scale, void* out, int m, int n,
                int k, int x_bf16, int cluster, int stages, cudaStream_t s) {
  const int chunks = (k + FV_KC - 1) / FV_KC;
  if (cluster < 1 || cluster > FV_MAX_CLUSTER || cluster > chunks || stages < 1 ||
      stages > FV_MAX_STAGES) {
    return (int)cudaErrorInvalidValue;
  }
  const int kcap = (chunks + cluster - 1) / cluster * FV_KC;
  const FvSmem lay(stages, std::min(FV_ROWS, m), kcap);
  const dim3 grid(cluster, (n + FV_CH - 1) / FV_CH, (m + FV_ROWS - 1) / FV_ROWS);
  if (lay.bytes > 227 * 1024 || grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap cmap;
  if (!tensor_map_2d(&cmap, codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, n, k, k, FV_CH, FV_BOX,
                     CU_TENSOR_MAP_SWIZZLE_128B)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* sc = (const float*)scale;
  if (x_bf16) {
    return (int)launch_cluster<a8_gemv_kernel<true>>(grid, FV_THREADS, lay.bytes, cluster, s, cmap,
                                                     x, sc, out, m, n, k, stages, kcap);
  }
  return (int)launch_cluster<a8_gemv_kernel<false>>(grid, FV_THREADS, lay.bytes, cluster, s, cmap,
                                                    x, sc, out, m, n, k, stages, kcap);
}

}  // namespace

extern "C" int wmt_a8_gemv(const void* x, const void* codes, const void* scale, void* out, int m,
                           int n, int k, int x_bf16, int cluster, int stages, void* stream) {
  if (m < 1 || n < 1 || k < 16 || k % 16) return (int)cudaErrorInvalidValue;
  return launch_gemv(x, codes, scale, out, m, n, k, x_bf16, cluster, stages,
                     (cudaStream_t)stream);
}

extern "C" int wmt_a8_quantize(const void* x, void* xq, void* sx, int m, int k, int x_bf16,
                               void* stream) {
  if (m < 1 || k < 64 || k % 64) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16) {
    a8_quantize_kernel<true><<<m, Q_THREADS, 0, s>>>(x, (int8_t*)xq, (float*)sx, k);
  } else {
    a8_quantize_kernel<false><<<m, Q_THREADS, 0, s>>>(x, (int8_t*)xq, (float*)sx, k);
  }
  return (int)cudaGetLastError();
}

extern "C" int wmt_a8_gemm(const void* xq, const void* sx, const void* codes, const void* scale,
                           void* out, int m, int n, int k, int out_bf16, int nt, int cluster,
                           int stages, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (out_bf16) {
    return tiled8::launch<true>(xq, sx, codes, scale, out, m, n, k, nt, cluster, stages, s);
  }
  return tiled8::launch<false>(xq, sx, codes, scale, out, m, n, k, nt, cluster, stages, s);
}
