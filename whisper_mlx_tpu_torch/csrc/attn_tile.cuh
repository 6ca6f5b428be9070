// The Hopper attention core shared by K2 (dense_attention.cu) and K4
// (flash_attention.cu): TMA loads into a ring of shared-memory stages
// guarded by full / empty mbarriers, wgmma for both products, and the score,
// probability and output tiles in registers.
//
// Block layout (THREADS = 384): warps 0-7 are two consumer warpgroups, each
// owning 64 query rows (BQ = 128 rows a block); warps 8-11 are the producer
// warpgroup, whose first thread issues every TMA load. The consumers raise
// their register limit with setmaxnreg to 240 and the producer lowers its
// own to 24: 2 x 128 x 240 + 128 x 24 = 64,512 registers, the 168 a thread
// that ptxas gives the block at entry. (A lone producer warp, three
// warpgroups rounded up, hung in setmaxnreg.inc on the H100, so the
// producer is a whole warpgroup, as in FlashAttention-3.)
//
// Shared-memory tiles are bf16, 64 columns (128 bytes) to a row, in the
// 128-byte swizzle that TMA writes and wgmma reads. A tile of R rows and
// HDP = 64 or 128 columns is HDP / 64 such column blocks of R x 128 bytes;
// head dims below 64 are loaded as 64 columns, the columns past hd filled
// with zeros by TMA, so they add nothing to q . k and their output columns
// are not stored. Every tile starts on a 1024-byte boundary (the swizzle's
// period), so a descriptor's base offset is 0.
//
// Layouts in registers (wgmma's m64nN fp32 accumulator): thread t of a
// warpgroup, warp w = t / 32, lane l, holds for every 8-column chunk j the
// values d[4j + 0, 1] of row 16w + l / 4 and d[4j + 2, 3] of row 16w + l / 4
// + 8, at columns 8j + 2 (l % 4) + {0, 1}. Four lanes share a row, so a row
// reduction is two __shfl_xor. The same layout, packed to bf16 pairs, is
// wgmma's A operand from registers, so P never leaves the registers.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90_async.cuh"

namespace attn {

constexpr int BQ = 128;            // query rows a block (two warpgroups)
constexpr int BK = 128;            // keys a tile
constexpr int CONSUMERS = 256;     // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and one producer warpgroup
// setmaxnreg limits (see the block layout above); an increase that the
// block's pool cannot meet never returns.
constexpr int CONSUMER_REGS = 240;
constexpr int PRODUCER_REGS = 24;
constexpr int COLS = 64;           // bf16 columns in one 128-byte swizzle row
constexpr float NEG = -1e30f;      // a masked score
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------- PTX

using wmt_async::mbar_arrive;
using wmt_async::mbar_expect_tx;
using wmt_async::mbar_fence_init;
using wmt_async::mbar_init;
using wmt_async::mbar_wait;
using wmt_async::smem_u32;

// One box of a 3-D tensor map (columns, rows, batch) into shared memory,
// completing `bytes` on the barrier.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int col, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(col), "r"(row), "r"(batch)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma's issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle. K-major tiles (Q, K):
// rows 128 bytes apart, 8-row groups sbo = 1024 bytes apart, lbo unused;
// one 16-wide k step is +32 bytes inside the row. MN-major tiles (V as
// P . V's B operand): 64 contiguous columns a row, k (key) rows 128 bytes
// apart, 8-key groups sbo = 1024 bytes apart, the next 64 columns lbo bytes
// on; one 16-key k step is +2048 bytes.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile, uint32_t lbo, uint32_t sbo) {
  uint64_t d = (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;  // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// ------------------------------------------------------------- wgmma
// (generated: one asm statement per shape; d is the accumulator in the
// layout above, accumulate = 0 overwrites it)

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A in registers (the accumulator
// layout of S, packed to bf16), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A in registers (the accumulator
// layout of S, packed to bf16), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ------------------------------------------------------------- tiles

// A tile of `rows` x HDP bf16 as HDP / 64 swizzled column blocks.
template <int HDP>
__host__ __device__ constexpr int tile_bytes(int rows) { return rows * HDP * 2; }

// S[64 x BK] = Q[64 x HDP] . K[BK x HDP]^T for one warpgroup.
template <int HDP>
__device__ __forceinline__ void qk_tile(float (&s)[BK / 2], const __nv_bfloat16* q,
                                        const __nv_bfloat16* k) {
  const unsigned char* qb = reinterpret_cast<const unsigned char*>(q);
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(k);
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const int off = (kk % 4) * 32;
    wgmma_ss_n128(s, sw128_desc(qb + (kk / 4) * 64 * 128 + off, 16, 1024),
                  sw128_desc(kb + (kk / 4) * BK * 128 + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
}

// O[64 x HDP] += P[64 x BK] . V[BK x HDP], P in registers as bf16 pairs.
template <int HDP>
__device__ __forceinline__ void pv_tile(float (&o)[HDP / 2], const uint32_t (&p)[BK / 16][4],
                                        const __nv_bfloat16* v) {
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(v);
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t desc = sw128_desc(vb + kk * 16 * 128, BK * 128, 1024);
    if constexpr (HDP == 64) {
      wgmma_rs_n64(o, p[kk], desc);
    } else {
      wgmma_rs_n128(o, p[kk], desc);
    }
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(o);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Two floats rounded to bf16 and back by one conversion instruction.
__device__ __forceinline__ float2 round2_bf16(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

// P as wgmma's A operand: the fp32 weights of S's layout packed to bf16.
__device__ __forceinline__ void pack_p(const float (&w)[BK / 2], uint32_t (&p)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) p[kk][r] = pack_bf16(w[8 * kk + 2 * r], w[8 * kk + 2 * r + 1]);
  }
}

// The row (0 or 1: l / 4 or l / 4 + 8 of the warp's 16) and column of
// accumulator register i.
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
}

// Set scores past `key_end` (and, when causal, past each row's own index)
// to NEG. key0 is the tile's first key, row0 / row1 this thread's rows.
__device__ __forceinline__ void mask_tile(float (&s)[BK / 2], int key0, int key_end, bool causal,
                                          int row0, int row1, int lane) {
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int key = key0 + acc_col(i, lane);
    const int row = (i & 2) ? row1 : row0;
    if (key >= key_end || (causal && key > row)) s[i] = NEG;
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
  return fmaxf(v, __shfl_xor_sync(FULL, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

// The tile's max of each of this thread's two rows (all four lanes agree).
__device__ __forceinline__ void tile_max(const float (&s)[BK / 2], float& m0, float& m1) {
  float a = NEG, b = NEG;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    if (i & 2) b = fmaxf(b, s[i]); else a = fmaxf(a, s[i]);
  }
  m0 = quad_max(a);
  m1 = quad_max(b);
}

// Write this warpgroup's 64 x hd output (o scaled by inv0 / inv1 per row)
// through `stage` (its Q tile, free once the last product has read it):
// bf16 pairs in, 16-byte rows out, rows at or past tq not stored.
template <int HDP>
__device__ __forceinline__ void store_out(const float (&o)[HDP / 2], float inv0, float inv1,
                                          __nv_bfloat16* stage, __nv_bfloat16* out, int row_base,
                                          int tq, int hd, int wg) {
  const int t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31;
  const int r0 = 16 * warp + (lane >> 2);
  uint32_t* st = reinterpret_cast<uint32_t*>(stage);
  named_sync(1 + wg, 128);  // the other warps' last wgmma has read Q
#pragma unroll
  for (int i = 0; i < HDP / 2; i += 2) {
    const int r = (i & 2) ? r0 + 8 : r0;
    const float inv = (i & 2) ? inv1 : inv0;
    st[(r * HDP + acc_col(i, lane)) / 2] = pack_bf16(o[i] * inv, o[i + 1] * inv);
  }
  named_sync(1 + wg, 128);
  const int chunks = hd / 8;  // 16-byte pieces of one output row
  for (int c = t; c < 64 * chunks; c += 128) {
    const int r = c / chunks, col = (c % chunks) * 8;
    if (row_base + r < tq) {
      *reinterpret_cast<uint4*>(out + (size_t)(row_base + r) * hd + col) =
          *reinterpret_cast<const uint4*>(stage + r * HDP + col);
    }
  }
}

// ------------------------------------------------------------- ring

// Shared memory of one block: each warpgroup's Q tile, STAGES K and V tiles
// and their barriers. Load n (a running count over the block's key tiles,
// passes included) goes to stage n % STAGES; full[stage] completes when its
// bytes have landed, empty[stage] when all eight consumer warps are done
// with it (lane 0 of each arrives once its warp's last wgmma on the stage
// has completed).
template <int HDP, int STAGES>
struct Ring {
  __nv_bfloat16 q[2][64 * HDP];
  __nv_bfloat16 k[STAGES][BK * HDP];
  __nv_bfloat16 v[STAGES][BK * HDP];
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
  uint64_t qbar;

  static __device__ __forceinline__ Ring& at(unsigned char* raw) {
    return *reinterpret_cast<Ring*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                    ~uintptr_t(1023));
  }

  // thread 0, before the block's __syncthreads
  __device__ __forceinline__ void init() {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    mbar_init(&qbar, 1);
    mbar_fence_init();
  }

  // producer lane: both warpgroups' 64-row Q tiles from row q0
  __device__ __forceinline__ void load_q(const CUtensorMap* map, int q0, int batch) {
    mbar_expect_tx(&qbar, 2 * tile_bytes<HDP>(64));
#pragma unroll
    for (int g = 0; g < 2; ++g) {
#pragma unroll
      for (int c = 0; c < HDP / COLS; ++c) {
        tma_load_3d(q[g] + c * 64 * COLS, map, &qbar, c * COLS, q0 + 64 * g, batch);
      }
    }
  }

  // producer lane: load n, keys from key0 of K (and of V when vmap is given)
  __device__ __forceinline__ void load_kv(int n, const CUtensorMap* kmap, const CUtensorMap* vmap,
                                          int key0, int batch) {
    const int stage = n % STAGES;
    if (n >= STAGES) mbar_wait(&empty[stage], ((n / STAGES) - 1) & 1);
    mbar_expect_tx(&full[stage], tile_bytes<HDP>(BK) * (vmap != nullptr ? 2 : 1));
#pragma unroll
    for (int c = 0; c < HDP / COLS; ++c) {
      tma_load_3d(k[stage] + c * BK * COLS, kmap, &full[stage], c * COLS, key0, batch);
      if (vmap != nullptr) {
        tma_load_3d(v[stage] + c * BK * COLS, vmap, &full[stage], c * COLS, key0, batch);
      }
    }
  }

  // consumer: wait for load n; returns its stage
  __device__ __forceinline__ int wait_full(int n) {
    const int stage = n % STAGES;
    mbar_wait(&full[stage], (n / STAGES) & 1);
    return stage;
  }

  // consumer warp, after its last wgmma on the stage has completed
  __device__ __forceinline__ void release(int stage) {
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[stage]);
  }
};

// Dynamic shared memory a launch asks for: the ring and room to align it.
template <class RingT>
constexpr int smem_bytes() { return (int)sizeof(RingT) + 1024; }

// This consumer thread's place: its warpgroup (0, 1), lane, and the two
// query rows it holds, given the block's first row q0.
struct Place {
  int wg, lane, row_base, row0, row1;
  __device__ __forceinline__ explicit Place(int q0) {
    wg = threadIdx.x >> 7;
    lane = threadIdx.x & 31;
    row_base = q0 + 64 * wg;
    row0 = row_base + 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);
    row1 = row0 + 8;
  }
};

// ------------------------------------------------------------- host

// A (batch, rows, hd) bf16 tensor as a 3-D map of boxes of `box_rows` x 64
// columns, 128-byte swizzle; reads past rows or hd fill zeros.
static inline bool tensor_map(CUtensorMap* map, const void* ptr, int batch, int rows, int hd,
                              int box_rows) {
  wmt_async::EncodeTiledFn fn = wmt_async::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)rows * hd * 2};
  const cuuint32_t box[3] = {(cuuint32_t)COLS, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
            box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace attn
