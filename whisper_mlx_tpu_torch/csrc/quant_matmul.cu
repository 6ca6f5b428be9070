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
// 6 ms at 3.35 TB/s. A whisper large-v3 step at 8 rows reads 500 MB, 0.15
// ms, over 193 calls of 1 to 41 MB: each call is short, so the card must be
// filled and the bytes in flight from the first cycle. Prefill (M = 128..512)
// is a GEMM: tensor cores.
//
// Three kernels:
// - quant_gemv_mma_kernel (int4 codes, bf16 x, M <= 8): the decode route.
//   A block of four warps owns 64 output columns and one contiguous run of
//   whole groups of K; a thread-block cluster of C blocks (1 to 8, chosen
//   from N and K: about 320 blocks, at most 2560 k a block) splits K, and
//   the blocks reduce their fp32 partial sums through distributed shared
//   memory in a fixed order (no atomics: a repeat is bit-equal). The codes
//   and fp32 affines of 256 k stream through a ring of 3 shared-memory
//   stages by 16-byte cp.async, two stages in flight while the block works
//   on the one that has landed. The tensor cores take the products with
//   mma.sync m16n8k16: A is 16 weight columns (dequantized in registers), B
//   is the 8 rows of x (at M < 8 the rest are zeros), so no row of the tile
//   is padding at 8 rows. Two codes become bf16x2 round_bf16(c * s) in one
//   mask-and-or and one bf16x2 FMA (dequant_bf16x2, shared with K6). Over
//   each 128 k a lane takes four whole words of its two columns, so every
//   code is read from shared memory once, without bank conflicts (odd
//   columns' pieces stored swizzled); the mma's k order follows the
//   words' nibble pairs (i, i + 4), and x is laid out the same way once,
//   into shared memory, when the block starts, its sums over each group
//   (the bias term's xg) taken in the same pass; the bias enters as xg * b
//   per group in fp32. On the H100 (chip_smoke.py, PERF.md) the large
//   linears stay bound by the issue of the dequantization, short of the
//   bytes, and whisper's 1-5 MB linears by a cold call's latency.
// - quant_gemv_kernel (fp32 x, 8-bit codes, and int4 shapes the route
//   above does not take: group sizes past 256, x too large for a block):
//   one warp per output row; each lane loads 16 bytes of codes (32 int4 /
//   16 int8 values of one group), dequantizes them in registers with the
//   rounding above, and takes their dot product with up to 8 rows of x;
//   a warp shuffle reduces. The bias is folded per lane as b * sum(x).
// - quant_gemm_kernel (bf16 x, M > 8; quant_tile.cuh, shared with K6): the
//   Hopper tiled core, wgmma with the codes dequantized straight into A
//   registers, a TMA ring, x's group sums in the kernel, K split across a
//   cluster where the grid would not fill the card; RowTiles below reads
//   K5's row-major words and (N, G) affines.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

#include "quant_tile.cuh"
#include "sm90_async.cuh"

namespace {

using namespace wmt_quant;
using namespace wmt_async;

constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// SIMT GEMV: fp32 x, 8-bit codes, and the int4 shapes the tensor-core
// route below does not take
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

// ---------------------------------------------------------------------------
// GEMV on tensor cores: int4 codes, bf16 x, M <= 8
// ---------------------------------------------------------------------------

constexpr int QV_THREADS = 128;                 // four warps
constexpr int QV_COLS = 64;                     // output columns of a block, 16 a warp
constexpr int QV_ROWS = 8;                      // rows of x: the mma's n
constexpr int QV_KC = 256;                      // k of one ring stage
constexpr int QV_CSTRIDE = QV_KC / 2;           // bytes of a column's codes in a stage; an
                                                // odd column's 16-byte pieces are stored
                                                // swizzled (piece ^ 4), so that two
                                                // neighbours' reads span all 32 banks
constexpr int QV_CODES = QV_COLS * QV_CSTRIDE;
constexpr int QV_MAX_STAGES = 3;
constexpr int QV_MAX_CLUSTER = 8;               // the portable cluster size
constexpr int QV_X_BYTES = 64 * 1024;           // most bytes of permuted x a block holds
constexpr int QV_FILL = 320;                    // blocks to aim for: about 2.4 an SM of an H100
constexpr int QV_KRANGE = 2560;                 // most k of a block's range, where the split allows

// floats of a column's affine window in a stage: its groups from a 16-byte
// boundary, a multiple of 4
__host__ __device__ constexpr int qv_aw(int group_size) {
  return (QV_KC / group_size + 3 + 3) & ~3;
}

__host__ __device__ constexpr int qv_stage(int group_size) {
  return QV_CODES + 2 * QV_COLS * qv_aw(group_size) * 4;
}

// x's row in shared memory: the block's k range in blocks of 128 k, each
// laid out as [jw][cq][8] so that lane cq reads its 32 k as four 16-byte
// loads (jw = 0..3), the 8 of each permuted to (0, 4, 1, 5, 2, 6, 3, 7); and
// 32 elements more, so that two neighbouring rows span all 32 banks
__host__ __device__ constexpr int qv_xw(int krange) {
  return (krange + 127) / 128 * 128 + 32;
}

// Shared memory: the ring | x permuted (m, xw) bf16 | x's sums over each 16
// k (m, krange / 16) | xg (m, krange / group_size) | the partial outputs
// that the other blocks of the cluster push here.
__global__ void __launch_bounds__(QV_THREADS)
quant_gemv_mma_kernel(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ wq,
                      const float* __restrict__ scales, const float* __restrict__ biases,
                      __nv_bfloat16* __restrict__ out, int m, int n, int k, int group_size,
                      int stages, int krange_max) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int cq = lane & 3;
  const int n0 = blockIdx.y * QV_COLS;
  if (csize > 1) cluster_arrive_relaxed();  // waited before the push to other blocks
  const int groups = k / group_size;
  // this block's k range: whole groups, split as evenly as they go
  const int g_begin = rank * groups / csize;
  const int kb = g_begin * group_size;
  const int ke = (rank + 1) * groups / csize * group_size;
  const int n_chunks = (ke - kb + QV_KC - 1) / QV_KC;
  const int aw = qv_aw(group_size);
  const int stage_bytes = qv_stage(group_size);
  const int xw = qv_xw(krange_max);
  const int gmax = krange_max / group_size;
  const int ncols = min(QV_COLS, n - n0);
  const long long n_aff = (long long)n * groups;  // floats of each affine tensor
  unsigned char* ring = smem;
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem + stages * stage_bytes);
  float* xsum = reinterpret_cast<float*>(xs + m * xw);
  float* xg = xsum + m * (krange_max / 16);
  float* red = xg + ((m * gmax + 3) & ~3);
  const unsigned char* wbytes = reinterpret_cast<const unsigned char*>(wq);

  // Chunk c of the block's k range into stage c % stages by 16-byte
  // cp.async: each column's codes (contiguous in the (N, K / 8) layout), and
  // its scales and biases of the chunk's groups as the window around them
  // that starts on a 16-byte boundary (zeros past the tensor's end); one
  // commit group a chunk.
  auto issue = [&](int c) {
    if (c < n_chunks) {
      unsigned char* dst = ring + (c % stages) * stage_bytes;
      const int k0 = kb + c * QV_KC;
      const int kc = min(QV_KC, ke - k0);
      // piece tid % 8 of columns tid / 8, tid / 8 + 16, ...
      const int piece = tid & (QV_KC / 32 - 1);
      if (piece < kc / 32) {
        for (int col = tid / (QV_KC / 32); col < ncols; col += QV_THREADS / (QV_KC / 32)) {
          cp_async16(dst + col * QV_CSTRIDE + (piece ^ ((col & 1) << 2)) * 16,
                     wbytes + (size_t)(n0 + col) * (k / 2) + k0 / 2 + piece * 16, true);
        }
      }
      // threads 0..63 scales, 64..127 biases, one column each
      const int col = tid & (QV_COLS - 1);
      if (col < ncols) {
        const float* src = tid < QV_COLS ? scales : biases;
        const long long first = (long long)(n0 + col) * groups + k0 / group_size;
        const long long start = first & ~3LL;
        const int count = (int)(first - start) + kc / group_size;
        float* adst = reinterpret_cast<float*>(dst + QV_CODES) + (tid >> 6) * QV_COLS * aw +
                      col * aw;
        for (int j = 0; j < count; j += 4) {
          const long long left = n_aff - (start + j);
          cp_async16_part(adst + j, left > 0 ? src + start + j : src,
                          (int)(left >= 4 ? 16 : max(0LL, left) * 4));
        }
      }
    }
    cp_async_commit();  // one group per call, empty or not, so the count holds
  };

  for (int c = 0; c < stages - 1; ++c) issue(c);

  // While the first stages land: x's rows over the k range into shared
  // memory in the layout of qv_xw, and their sums over each 16 k, then over
  // each group, in a fixed order.
  const int blocks16 = (ke - kb) / 16;
  for (int p = tid; p < m * blocks16; p += QV_THREADS) {
    const int r = p / blocks16;
    const int b = p % blocks16;
    const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)r * k + kb + 16 * b);
    float sum = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // k 16 b + 8 h .. + 7: lane cq = (2 b + h) / 4 % 4 of its block
      const uint4 u = __ldg(src + h);
      const uint32_t wd[4] = {u.x, u.y, u.z, u.w};
      uint32_t v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[e] = (wd[e >> 1] >> (16 * (e & 1))) & 0xffffu;
        sum += bf16_bits_to_float(v[e]);
      }
      const int q8 = 2 * b + h;  // the 8 k's index in the row
      const int pos = q8 / 16 * 128 + (q8 % 4) * 32 + (q8 / 4 % 4) * 8;
      *reinterpret_cast<uint4*>(xs + r * xw + pos) =
          make_uint4(v[0] | (v[4] << 16), v[1] | (v[5] << 16), v[2] | (v[6] << 16),
                     v[3] | (v[7] << 16));
    }
    xsum[r * (krange_max / 16) + b] = sum;
  }
  __syncthreads();
  const int per_group = group_size / 16;
  const int ngroups = (ke - kb) / group_size;
  for (int p = tid; p < m * ngroups; p += QV_THREADS) {
    const int r = p / ngroups;
    const int g = p % ngroups;
    float sum = 0.f;
    for (int b = 0; b < per_group; ++b) sum += xsum[r * (krange_max / 16) + g * per_group + b];
    xg[r * gmax + g] = sum;
  }

  // Warp w owns columns 16 w .. 16 w + 15 of the block: A's rows. Lane (gq,
  // cq) holds A of columns c0 = 16 w + gq and c1 = c0 + 8, B of x row gq, and
  // C of columns c0, c1 at x rows 2 cq, 2 cq + 1. Over each 128 k the lane
  // takes the words 4 cq .. 4 cq + 3 of its columns (k = 32 cq .. 32 cq + 31,
  // one group), word jw for the k-steps 2 jw and 2 jw + 1, its nibble pairs
  // (0, 4), (1, 5) in the first and (2, 6), (3, 7) in the second: every code
  // is read from shared memory once, and x is laid out to match (qv_xw).
  // Two chains of mma keep two products in flight.
  const int c0 = warp * 16 + gq;
  const int c1 = c0 + 8;
  // where each column's affines start in its window: (column * G + g) mod 4
  const int o0 = (int)(((long long)(n0 + c0) * groups + g_begin) & 3);
  const int o1 = (int)(((long long)(n0 + c1) * groups + g_begin) & 3);
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // every thread is done with the stage refilled now (and xg is in)
    issue(c + stages - 1);
    cp_async_wait(stages - 1);  // this thread's copies of chunk c have landed
    __syncthreads();            // ... and every thread's
    const unsigned char* st = ring + (c % stages) * stage_bytes;
    const float* sc = reinterpret_cast<const float*>(st + QV_CODES);
    const float* bi = sc + QV_COLS * aw;
    const int k0 = c * QV_KC;  // within the block's range
    const int kc = min(QV_KC, ke - kb - k0);
    // chunk c starts at group g_begin + c * QV_KC / group_size: its window's
    // offset moves by that many floats, mod 4
    const int oc = c * (QV_KC / group_size);
    const int a0 = c0 * aw + ((o0 + oc) & 3);
    const int a1 = c1 * aw + ((o1 + oc) & 3);
    for (int j = 0; j < kc / group_size; ++j) {  // the bias: every group, rows 2 cq, 2 cq + 1
      const int g = k0 / group_size + j;
      const float xg0 = 2 * cq < m ? xg[2 * cq * gmax + g] : 0.f;
      const float xg1 = 2 * cq + 1 < m ? xg[(2 * cq + 1) * gmax + g] : 0.f;
      const float ba = bi[a0 + j];
      const float bb = bi[a1 + j];
      acc[0][0] = fmaf(xg0, ba, acc[0][0]);
      acc[0][1] = fmaf(xg1, ba, acc[0][1]);
      acc[0][2] = fmaf(xg0, bb, acc[0][2]);
      acc[0][3] = fmaf(xg1, bb, acc[0][3]);
    }
    for (int blk = 0; blk < kc; blk += 128) {
      // the lane's 32 k: in the chunk (k ranges are whole groups of >= 32)?
      const bool in = blk + 32 * cq < kc;
      const int j = (blk + 32 * cq) / group_size;  // its group in the chunk
      uint32_t sa2 = 0u, nsa2 = 0u, sb2 = 0u, nsb2 = 0u;
      uint4 wa = make_uint4(0u, 0u, 0u, 0u);
      uint4 wb = wa;
      if (in) {
        scale_pairs(sc[a0 + j], sa2, nsa2);
        scale_pairs(sc[a1 + j], sb2, nsb2);
        const int piece = ((blk / 128) * 4 + cq) ^ ((c0 & 1) << 2);  // c1 = c0 + 8: the same
        wa = *reinterpret_cast<const uint4*>(st + c0 * QV_CSTRIDE + 16 * piece);
        wb = *reinterpret_cast<const uint4*>(st + c1 * QV_CSTRIDE + 16 * piece);
      }
      const uint16_t* xr = xs + gq * xw + k0 + blk + 8 * cq;
      const bool xin = in && gq < m;
      const uint32_t va[4] = {wa.x, wa.y, wa.z, wa.w};
      const uint32_t vb[4] = {wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int jw = 0; jw < 4; ++jw) {
        uint4 xv = make_uint4(0u, 0u, 0u, 0u);
        if (xin) xv = *reinterpret_cast<const uint4*>(xr + 32 * jw);
        mma_16816(acc[0], dequant_bf16x2(va[jw], sa2, nsa2), dequant_bf16x2(vb[jw], sb2, nsb2),
                  dequant_bf16x2(va[jw] >> 4, sa2, nsa2), dequant_bf16x2(vb[jw] >> 4, sb2, nsb2),
                  xv.x, xv.y);
        mma_16816(acc[1], dequant_bf16x2(va[jw] >> 8, sa2, nsa2),
                  dequant_bf16x2(vb[jw] >> 8, sb2, nsb2), dequant_bf16x2(va[jw] >> 12, sa2, nsa2),
                  dequant_bf16x2(vb[jw] >> 12, sb2, nsb2), xv.z, xv.w);
      }
    }
  }
  cp_async_wait(0);
  // acc: (column c0, rows 2 cq, 2 cq + 1), then (column c1, the same rows)
  if (csize == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = n0 + (i < 2 ? c0 : c1);
      const int r = 2 * cq + (i & 1);
      if (r < m && col < n) out[(size_t)r * n + col] = __float2bfloat16_rn(acc[0][i] + acc[1][i]);
    }
    return;
  }
  // Output e = column * m + row belongs to block e % C, which sums the
  // partials that every block pushed into its slots in block order: one
  // cluster barrier, after which no block reads another's shared memory.
  const int slots = (QV_COLS * m + csize - 1) / csize;
  cluster_wait();  // every block of the cluster has started
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = i < 2 ? c0 : c1;
    const int r = 2 * cq + (i & 1);
    if (r < m && col < ncols) {
      const int e = col * m + r;
      cluster.map_shared_rank(red, e % csize)[rank * slots + e / csize] = acc[0][i] + acc[1][i];
    }
  }
  cluster.sync();
  for (int slot = tid; slot < slots; slot += QV_THREADS) {
    const int e = slot * csize + rank;
    const int col = e / m;
    if (col < ncols) {
      float sum = 0.f;
      for (int src = 0; src < csize; ++src) sum += red[src * slots + slot];  // block 0 first
      out[(size_t)(e % m) * n + n0 + col] = __float2bfloat16_rn(sum);
    }
  }
}

// The tensor-core GEMV's launch: K's split across the cluster (at least
// enough blocks that each holds its x, then doubled until the grid fills
// the card or the blocks would hold less than a group), the ring's depth
// and the shared memory. False for shapes it does not take.
struct GemvPlan {
  int cluster, stages, krange_max, smem;
};

bool plan_gemv_mma(int m, int n, int k, int group_size, GemvPlan& p) {
  if (m > QV_ROWS || group_size > QV_KC || QV_KC % group_size || group_size % 32) return false;
  const int groups = k / group_size;
  const long long tiles = (n + QV_COLS - 1) / QV_COLS;
  auto krange = [&](int c) { return (groups + c - 1) / c * group_size; };
  int c = 1;
  while (c < QV_MAX_CLUSTER && 2LL * m * (krange(c) + 16) > QV_X_BYTES) c *= 2;
  if (2LL * m * (krange(c) + 16) > QV_X_BYTES || tiles > 65535) return false;
  while (c < QV_MAX_CLUSTER && (tiles * c < QV_FILL || krange(c) > QV_KRANGE) && 2 * c <= groups) {
    c *= 2;
  }
  c = std::min(c, groups);
  p.cluster = c;
  p.krange_max = krange(c);
  p.stages = std::min(QV_MAX_STAGES, (p.krange_max + QV_KC - 1) / QV_KC);
  const int gmax = p.krange_max / group_size;
  p.smem = p.stages * qv_stage(group_size) + m * qv_xw(p.krange_max) * 2 +
           m * (p.krange_max / 16) * 4 + ((m * gmax + 3) & ~3) * 4 +
           (QV_COLS * m + c - 1) / c * c * 4;
  return p.smem <= 227 * 1024;
}

// K5's weights for the tiled core (quant_tile.cuh): words (N, K / per_word)
// int32, a stage's TMA box a block's columns x 64 k of words (32 or 64 bytes
// a column). Affines (N, G) fp32: a column's groups lie G floats apart, so
// a stage takes each column's window of 4 groups around its own, [c][4],
// as one TMA box of 16-byte rows (G a multiple of 4: the box's row stride);
// for other G the lanes copy the stage's groups 4 bytes at a time, a
// transaction each, which is slower on the card (PERF.md).
template <int BITS>
struct RowTiles {
  static constexpr int PW = 32 / BITS;        // codes a word
  static constexpr int WBYTES = tiled::SK / PW * 4;
  static constexpr bool EIGHT = BITS == 8;
  static constexpr int AW = 4;                // groups of a column's affine window
  CUtensorMap wmap, smap, bmap;
  const int32_t* wq;
  const float* scales;
  const float* biases;
  int n, k, groups;
  int aff_tma;  // the affines by TMA boxes (G a multiple of 4)

  __host__ __device__ static constexpr int aff_floats(int cols, int gs) { return cols * AW; }
  bool prepare(int cols, int gs) {
    aff_tma = groups % AW == 0;
    if (!tensor_map_2d(&wmap, wq, CU_TENSOR_MAP_DATA_TYPE_INT32, n, k / PW, 4LL * (k / PW), cols,
                       tiled::SK / PW, CU_TENSOR_MAP_SWIZZLE_NONE)) {
      return false;
    }
    return !aff_tma ||
           (tensor_map_2d(&smap, scales, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, n, groups, 4LL * groups,
                          cols, AW, CU_TENSOR_MAP_SWIZZLE_NONE) &&
            tensor_map_2d(&bmap, biases, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, n, groups, 4LL * groups,
                          cols, AW, CU_TENSOR_MAP_SWIZZLE_NONE));
  }
  template <int COLS>
  __device__ __forceinline__ int tx(int gs) const {
    return COLS * WBYTES + (aff_tma ? 2 * COLS * AW * 4 : 0);
  }
  // where column c's affine of the stage's group gi sits (g0 the stage's first group)
  template <int COLS>
  __device__ __forceinline__ int aff(int c, int g0, int gi) const {
    return c * AW + (g0 & (AW - 1)) + gi;
  }
  template <int COLS>
  __device__ __forceinline__ void load(unsigned char* w, float* sc, float* bi, uint64_t* bar,
                                       int n0, int k0, int gs, int lane) const {
    const int g0 = k0 / gs;
    if (lane == 0) {
      tma_load_2d(w, &wmap, bar, k0 / PW, n0);
      if (aff_tma) {
        tma_load_2d(sc, &smap, bar, g0 & ~(AW - 1), n0);
        tma_load_2d(bi, &bmap, bar, g0 & ~(AW - 1), n0);
      }
    }
    if (!aff_tma) {  // the stage's groups, zeros past N
      const int gps = tiled::gps_of(gs);
      const int per = gps * COLS;
      for (int p = lane; p < 2 * per; p += 32) {
        const int which = p >= per;
        const int r = p - which * per;  // column r / gps, group r % gps
        const int c = r / gps, gi = r % gps;
        const bool ok = n0 + c < n;
        const float* src = which ? biases : scales;
        cp_async4_part((which ? bi : sc) + aff<COLS>(c, g0, gi),
                       ok ? src + (size_t)(n0 + c) * groups + g0 + gi : src, ok ? 4 : 0);
      }
    }
  }
  // k step kk's A fragment of columns c0, c0 + 1 (the stage's rows of
  // WBYTES): 4-bit words 2 kk (k 0-7 of the step) and 2 kk + 1; 8-bit
  // words 4 kk + t / 2 and 4 kk + 2 + t / 2, bytes 2 (t % 2) and on
  template <int COLS>
  __device__ __forceinline__ void dequant(const unsigned char* wt, int c0, int kk, int t,
                                          const uint32_t (&sp)[4], uint32_t (&a)[4]) const {
    if constexpr (BITS == 4) {
      const uint2 u0 = *reinterpret_cast<const uint2*>(wt + c0 * WBYTES + 8 * kk);
      const uint2 u1 = *reinterpret_cast<const uint2*>(wt + (c0 + 1) * WBYTES + 8 * kk);
      a[0] = tiled::dq_pair(tiled::nibble_pair(u0.x, t), sp[0], sp[1]);
      a[1] = tiled::dq_pair(tiled::nibble_pair(u1.x, t), sp[2], sp[3]);
      a[2] = tiled::dq_pair(tiled::nibble_pair(u0.y, t), sp[0], sp[1]);
      a[3] = tiled::dq_pair(tiled::nibble_pair(u1.y, t), sp[2], sp[3]);
    } else {
      const uint32_t* p = reinterpret_cast<const uint32_t*>(wt + c0 * WBYTES) + 4 * kk + (t >> 1);
      const int b = 2 * (t & 1);
      a[0] = tiled::dq_bytes(p[0], b, sp[0], sp[1]);
      a[1] = tiled::dq_bytes(p[WBYTES / 4], b, sp[2], sp[3]);
      a[2] = tiled::dq_bytes(p[2], b, sp[0], sp[1]);
      a[3] = tiled::dq_bytes(p[WBYTES / 4 + 2], b, sp[2], sp[3]);
    }
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
  GemvPlan plan;
  if (bits == 4 && x_bf16 && plan_gemv_mma(m, n, k, group_size, plan)) {
    return (int)launch_cluster<quant_gemv_mma_kernel>(
        dim3(plan.cluster, (n + QV_COLS - 1) / QV_COLS), QV_THREADS, plan.smem, plan.cluster,
        (cudaStream_t)stream, (const __nv_bfloat16*)x, (const int32_t*)wq,
        (const float*)scales, (const float*)biases, (__nv_bfloat16*)out, m, n, k, group_size,
        plan.stages, plan.krange_max);
  }
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

extern "C" int wmt_quant_gemm(const void* x, const void* wq, const void* scales,
                              const void* biases, void* out, int m, int n, int k, int bits,
                              int group_size, int nt, int cluster, int stages, void* stream) {
  if (!valid_quant(m, n, k, bits, group_size)) return (int)cudaErrorInvalidValue;
  auto run = [&](auto f) {
    f.wq = (const int32_t*)wq;
    f.scales = (const float*)scales;
    f.biases = (const float*)biases;
    f.n = n;
    f.k = k;
    f.groups = k / group_size;
    return tiled::launch(x, f, out, m, n, k, group_size, nt, cluster, stages,
                         (cudaStream_t)stream);
  };
  return bits == 4 ? run(RowTiles<4>{}) : run(RowTiles<8>{});
}
