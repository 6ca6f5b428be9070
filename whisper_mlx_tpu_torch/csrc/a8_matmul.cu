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
// - a8_quantize_kernel + a8_gemm_kernel (M > 8, K a multiple of 64): x's
//   rows quantized into device memory by one block each, then 64 x 64
//   output tiles, K in steps of 64; the quantized x tile and the code tile
//   go to shared memory in 16-wide k slices and wmma s8 x s8 -> s32
//   multiplies them. Not yet TMA or wgmma: later work.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>

#include "sm90_async.cuh"

using namespace nvcuda;

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
  if (m < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16) {
    a8_quantize_kernel<true><<<m, Q_THREADS, 0, s>>>(x, (int8_t*)xq, (float*)sx, k);
  } else {
    a8_quantize_kernel<false><<<m, Q_THREADS, 0, s>>>(x, (int8_t*)xq, (float*)sx, k);
  }
  return (int)cudaGetLastError();
}

extern "C" int wmt_a8_gemm(const void* xq, const void* sx, const void* codes, const void* scale,
                           void* out, int m, int n, int k, int out_bf16, void* stream) {
  if (m < 1 || n < 1 || k < TK || k % TK) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int8_t* q = (const int8_t*)xq;
  const float* sxf = (const float*)sx;
  const int8_t* c = (const int8_t*)codes;
  const float* sc = (const float*)scale;
  if (out_bf16) {
    a8_gemm_kernel<true><<<grid, GM_THREADS, 0, s>>>(q, sxf, c, sc, out, m, n, k);
  } else {
    a8_gemm_kernel<false><<<grid, GM_THREADS, 0, s>>>(q, sxf, c, sc, out, m, n, k);
  }
  return (int)cudaGetLastError();
}
