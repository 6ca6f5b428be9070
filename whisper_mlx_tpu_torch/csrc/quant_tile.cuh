// Group-affine dequant-matmul pieces shared by kernel K5 (quant_matmul.cu,
// weights (N, K / per_word) row-major) and kernel K6 (quant_matmul_mb.cu,
// weights N-contiguous): the bf16 helpers, the bf16x2 dequantization and
// the m16n8k16 mma of their few-row routes, the x loader, and the tiled
// core that serves bf16 x with more than 8 rows (namespace tiled, below).
// Numerics (the TPU kernels'): each group's scale is rounded to bf16, each
// code * scale is rounded to bf16, the products with x accumulate in fp32;
// the bias enters as xg @ b^T in fp32, xg being x's per-group sums.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "attn_tile.cuh"
#include "sm90_async.cuh"

namespace wmt_quant {

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
// The tiled core: bf16 x with more than 8 rows (K5's and K6's route up to the
// 512 rows of WTPU_QMM_PALLAS_MAX_ROWS), for Hopper.
//
// Replaces, above 8 rows: whisper_mlx_tpu/ops/quant_pallas.py:113
// quant_matmul_pallas (_quant_matmul_kernel) and
// whisper_mlx_tpu/ops/quant_pallas_mb.py:354 quant_matmul_mbt (_mbt_kernel).
//
// What bounds it on the H100: a Qwen prefill (128-512 rows) is a GEMM, bound
// by the tensor cores (a Qwen3-32B layer's four linears at 384 rows: 374.5
// GFLOP, 0.379 ms at 989 TFLOP/s); whisper's first decode step (24 rows) by
// the bytes of codes and affines (the five decode matmuls: 0.0171 ms). What
// the design does about each:
// - The weights are wgmma's A, dequantized straight into registers: a
//   warpgroup owns 64 (or 128) output columns as the m64 rows of
//   wgmma.m64nNk16, x's rows are its N (16, 32, 64 or 128 a block), read from
//   a 128-byte-swizzled shared-memory tile. Each weight tile is dequantized
//   once for all the block's rows. A lane of an A fragment holds k = 2t,
//   2t + 1, 2t + 8, 2t + 9 of its two rows (columns), an MLX word 8
//   consecutive k: the lane takes byte t of each word (a byte_perm of the
//   word and the word >> 4 puts nibbles 2t, 2t + 1 in bits 0-3 and 16-19),
//   then one lop3 and one bf16x2 FMA (dequant_bf16x2's exact trick). 8-bit
//   codes go through fp32: 2^23 + c from one byte_perm, one FMA to c * s
//   (exact), one cvt to the bf16 pair. A warp's 16 A rows are its 16
//   columns interleaved (row g column 2g, row g + 8 column 2g + 1), so a
//   lane's two columns are neighbours (K6's N-major words in one 8-byte
//   load, bf16x2 stores of the output).
// - A ring of `stages` shared-memory slots of 64 k (x tile, weight tile,
//   scales, biases, x's group sums) with full, ready and empty mbarriers.
//   Producer warp 0's first lane keeps TMA boxes of x and the codes in
//   flight, and of K5's affines (N, G): a box of each column's 4-group
//   window a stage (4-byte copies of K5's affines, a transaction each,
//   slowed the ring); its 32 lanes copy K6's (G, Np)
//   affines by 16-byte cp.async, completing on the same full barrier; the
//   lane fences the async proxy after each empty wait. Producer warps 1-3
//   sum x's rows over each group from the landed tile (the bias term's xg,
//   so the wrapper runs no reduction) and arrive on `ready`. The producer
//   is a whole warpgroup (a lone producer warp's setmaxnreg never
//   returned, attn_tile.cuh).
// - The consumers commit two k steps a group and dequantize the next two
//   while those run (A double-buffered, wgmma.wait_group 1). A stage that
//   ends groups drains its products and adds xg * b of each in fp32 FMAs.
//   At 128 rows the two consumer warpgroups take turns on the tensor cores
//   a stage at a time, so one drains and adds its bias while the other's
//   wgmma run.
// - A 384-row prefill runs in blocks of 256 columns x 128 rows (128
//   accumulator registers a consumer thread): the most columns a block can
//   hold per byte of x staged, since x is what every column block reads
//   again. Short M (16-64 rows) takes 128 columns a block, two blocks an SM.
// - The wrapper's plan (ops/quant_matmul.py:tiled_plan) splits K across a
//   thread-block cluster of 1, 2, 4 or 8 blocks on group boundaries where
//   the grid would not fill the card; the blocks sum their fp32 partials in
//   block order through distributed shared memory (the ring, free by then;
//   16-byte remote stores, two cluster barriers): one launch a call, no
//   atomics, a repeat bit-equal.
// On the H100 (PERF.md): a Qwen3-32B layer's four linears at 384 rows take
// 1.12-1.13 ms (the wmma form 5.29-5.31), 34 % of the bound; what holds it, by
// throwaway builds without each part: the bias term's fp32 FMAs and the
// drain before them, then the dequantization's issue.
//
// A format F (K5: RowTiles in quant_matmul.cu; K6: ColTiles in
// quant_matmul_mb.cu), passed as a __grid_constant__ parameter holding its
// tensor maps, gives:
//   F::WBYTES          bytes of one column's codes in a 64-k stage (32, 64)
//   F::EIGHT           8-bit codes (the fp32 conversion)
//   F::aff_floats(cols, gs)  floats of one affine array a slot holds
//   f.prepare(cols, gs)  encode its tensor maps (host)
//   f.tx<COLS>(gs)     the bytes of the TMA boxes f.load issues a stage
//   f.load<COLS>(...)  the codes, scales and biases of one stage into the
//                      slot: lane 0's TMA boxes and the 32 lanes' cp.async
//   f.aff<COLS>(c, g0, gi)  where column c's affine of the stage's group gi sits
//   f.dequant<COLS>(...)  one k step's A fragment of the lane's two columns
// ---------------------------------------------------------------------------

namespace tiled {

namespace cg = cooperative_groups;

constexpr int THREADS = 384;    // two consumer warpgroups and one producer warpgroup
constexpr int CONSUMERS = 256;
constexpr int SUMMERS = 96;     // producer warps 1-3
constexpr int SK = 64;          // k of a ring stage: one 128-byte row of x
constexpr int MAX_STAGES = 8;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
constexpr int SMEM_LIMIT = 227 * 1024;
// setmaxnreg at 128 rows: 2 x 128 x 224 + 128 x 56 = 64,512, the 168 a
// thread ptxas gives a block of 384 at entry
constexpr int CONSUMER_REGS = 224;
constexpr int PRODUCER_REGS = 56;
constexpr uint32_t FULL_ARRIVALS = 1 + 32;  // lane 0's expect_tx, every lane's cp.async

// 64-column A tiles of a consumer warpgroup, and a block's columns
__host__ __device__ constexpr int tiles_of(int nt) { return nt == 128 ? 2 : 1; }
__host__ __device__ constexpr int cols_of(int nt) { return 128 * tiles_of(nt); }
__host__ __device__ constexpr int round_up(int v, int a) { return (v + a - 1) / a * a; }
// groups a stage's affines and sums hold: 64 / gs below 64 k, else one
__host__ __device__ constexpr int gps_of(int gs) { return gs < SK ? SK / gs : 1; }

// Shared memory (mirrored by ops/quant_matmul.py:tiled_smem): `stages`
// slots of [x tile nt x 128 B | codes cols x wbytes | scales (aff floats) |
// biases (aff) | xg (gps, nt)], each from a 1024-byte boundary, then
// the full, ready and empty barriers; 1024 bytes more to align the base.
struct Layout {
  int w, sc, bi, xg, slot, bars, bytes;
  __host__ __device__ Layout(int nt, int wbytes, int aff, int gs, int stages) {
    const int cols = cols_of(nt), gps = gps_of(gs);
    w = round_up(nt * 128, 1024);
    sc = w + cols * wbytes;
    bi = sc + aff * 4;
    xg = bi + aff * 4;
    slot = round_up(xg + gps * nt * 4, 1024);
    bars = stages * slot;
    bytes = bars + 3 * stages * 8 + 1024;
  }
};

// arrive on named barrier `id` of `threads` without waiting
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D[64 x N] += A[64 x 16] . B[16 x N]: A in registers (bf16 pairs, mma.sync's
// A layout a warp of 16 rows), B K-major in shared memory (x's N rows of
// 16 k); generated, one asm statement a shape.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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

// nibbles 2t, 2t + 1 of a word (byte t) in bits 0-3 and 16-19
__device__ __forceinline__ uint32_t nibble_pair(uint32_t w, int t) {
  return __byte_perm(w, w >> 4, t | ((t + 4) << 8));
}

// bf16x2 round_bf16(c * s) of the codes in bits 0-3 and 16-19 of v (the
// rest ignored): one lop3, one bf16x2 FMA (dequant_bf16x2)
__device__ __forceinline__ uint32_t dq_pair(uint32_t v, uint32_t s2, uint32_t ns2) {
  uint32_t pair, w;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(pair) : "r"(v), "n"(0x000F000F), "r"(0x43004300));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(w) : "r"(pair), "r"(s2), "r"(ns2));
  return w;
}

// bf16x2 round_bf16(c * s) of bytes b, b + 1 of an 8-bit word: 2^23 + c as
// fp32 from one byte_perm, c * s = fma(2^23 + c, s, -2^23 s) exactly (16
// significant bits), one rounding to bf16; s and -2^23 s as fp32 bits
__device__ __forceinline__ uint32_t dq_bytes(uint32_t w, int b, uint32_t s, uint32_t ns) {
  const float f0 = __uint_as_float(__byte_perm(w, 0x4B000000u, b | 0x7540));
  const float f1 = __uint_as_float(__byte_perm(w, 0x4B000000u, (b + 1) | 0x7540));
  const __nv_bfloat162 v = __floats2bfloat162_rn(fmaf(f0, __uint_as_float(s), __uint_as_float(ns)),
                                                 fmaf(f1, __uint_as_float(s), __uint_as_float(ns)));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the scale operands of a lane's two columns: 4-bit codes bf16x2 (s, s),
// (-128 s, -128 s); 8-bit fp32 s, -2^23 s; s rounded to bf16 either way
template <bool EIGHT>
__device__ __forceinline__ void scale_ops(float s0, float s1, uint32_t (&sp)[4]) {
  if constexpr (EIGHT) {
    const float r0 = round_bf16(s0), r1 = round_bf16(s1);
    sp[0] = __float_as_uint(r0);
    sp[1] = __float_as_uint(-8388608.f * r0);
    sp[2] = __float_as_uint(r1);
    sp[3] = __float_as_uint(-8388608.f * r1);
  } else {
    scale_pairs(s0, sp[0], sp[1]);
    scale_pairs(s1, sp[2], sp[3]);
  }
}

// one bf16 output pair (columns col, col + 1 of a row); n odd or the edge:
// one value at a time
__device__ __forceinline__ void store_pair(__nv_bfloat16* out, int m, int n, int row, int col,
                                           float v0, float v1) {
  if (row >= m) return;
  __nv_bfloat16* p = out + (size_t)row * n + col;
  if (col + 1 < n && (n & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (col < n) p[0] = __float2bfloat16_rn(v0);
    if (col + 1 < n) p[1] = __float2bfloat16_rn(v1);
  }
}

// Block (rank r of a cluster of C along grid.x, row block blockIdx.y of NT
// rows, column block blockIdx.z of cols_of(NT) columns; row blocks run
// next to each other, so a column block's weights come from device memory
// once) takes K's units (groups of more than 64 k keep their stages in one
// block) [r * U / C, (r + 1) * U / C).
template <class F, int NT>
__global__ void __launch_bounds__(THREADS, NT == 128 ? 1 : 2)
quant_gemm_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ F f,
                  __nv_bfloat16* __restrict__ out, int m, int n, int k, int gs, int stages) {
  constexpr int TILES = tiles_of(NT);
  constexpr int COLS = cols_of(NT);
  constexpr int NA = NT / 2;  // accumulator registers of one 64-column tile
  extern __shared__ unsigned char smem_raw[];
  // aligned by an offset from the array, so the compiler keeps the shared
  // address space
  unsigned char* smem = smem_raw + ((1024u - (wmt_async::smem_u32(smem_raw) & 1023u)) & 1023u);
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const Layout L(NT, F::WBYTES, F::aff_floats(COLS, gs), gs, stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* ready = full + stages;
  uint64_t* empty = ready + stages;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // the warp's index, known warp-uniform to the compiler (a role branch on
  // threadIdx alone made ptxas serialize the wgmma in divergent paths)
  const int warp_id = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int m0 = blockIdx.y * NT;
  const int n0 = blockIdx.z * COLS;
  const int unit = gs > SK ? gs / SK : 1;
  const int units = k / SK / unit;
  const int kb = rank * units / csize * unit * SK;
  const int ns = ((rank + 1) * units / csize - rank * units / csize) * unit;
  // a stage ends a group: always below 64 k; above, every gs / 64 stages
  // (a block's range starts on a group)
  auto ends_group = [&](int i) { return gs <= SK || ((i + 1) * SK) % gs == 0; };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      wmt_async::mbar_init(&full[s], FULL_ARRIVALS);
      wmt_async::mbar_init(&ready[s], SUMMERS);
      wmt_async::mbar_init(&empty[s], CONSUMERS);
    }
    wmt_async::mbar_fence_init();
  }
  __syncthreads();

  if (warp_id >= CONSUMERS / 32) {
    if constexpr (NT == 128) attn::regs_dec<PRODUCER_REGS>();
    if (warp_id == CONSUMERS / 32) {
      // warp 0: the ring's loads, `stages` ahead of the consumers
      for (int i = 0; i < ns; ++i) {
        const int s = i % stages;
        if (i >= stages) wmt_async::mbar_wait(&empty[s], ((i / stages) - 1) & 1);
        unsigned char* st = smem + s * L.slot;
        const int k0 = kb + i * SK;
        if (lane == 0) {
          wmt_async::fence_proxy_async();  // the consumers' reads of the slot before TMA's writes
          wmt_async::mbar_expect_tx(&full[s], NT * 128 + f.template tx<COLS>(gs));
          wmt_async::tma_load_2d(st, &xmap, &full[s], k0, m0);
        }
        f.template load<COLS>(st + L.w, reinterpret_cast<float*>(st + L.sc),
                              reinterpret_cast<float*>(st + L.bi), &full[s], n0, k0, gs, lane);
        wmt_async::cp_async_mbar_arrive(&full[s]);
      }
    } else {
      // warps 1-3: x's sums over each group (over each 16 k, summed in
      // order, carried across stages for groups past 64 k), rows p and p + 96
      const int p = tid - CONSUMERS - 32;
      float carry[2] = {0.f, 0.f};
      for (int i = 0; i < ns; ++i) {
        const int s = i % stages;
        wmt_async::mbar_wait(&full[s], (i / stages) & 1);
        const unsigned char* xt = smem + s * L.slot;
        float* xg = reinterpret_cast<float*>(smem + s * L.slot + L.xg);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int r = p + SUMMERS * rr;
          if (r < NT) {
            float h[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int c = 0; c < 8; ++c) {  // 16-byte chunk c (k 8c .. 8c + 7), swizzled
              const uint4 u = *reinterpret_cast<const uint4*>(xt + r * 128 + ((c ^ (r & 7)) << 4));
              const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                h[c >> 1] += bf16_bits_to_float(w[e] & 0xffffu);
                h[c >> 1] += bf16_bits_to_float(w[e] >> 16);
              }
            }
            if (gs == 16) {
#pragma unroll
              for (int q = 0; q < 4; ++q) xg[q * NT + r] = h[q];
            } else if (gs == 32) {
              xg[r] = h[0] + h[1];
              xg[NT + r] = h[2] + h[3];
            } else {
              carry[rr] += (h[0] + h[1]) + (h[2] + h[3]);
              if (ends_group(i)) {
                xg[r] = carry[rr];
                carry[rr] = 0.f;
              }
            }
          }
        }
        wmt_async::mbar_arrive(&ready[s]);
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
  const int t = lane & 3;
  int cb[TILES];  // the lane's first column of each tile in the block (cb + 1 the other)
#pragma unroll
  for (int tau = 0; tau < TILES; ++tau) cb[tau] = (wg * TILES + tau) * 64 + 16 * warp + 2 * (lane >> 2);
  float acc[TILES][NA];
#pragma unroll
  for (int tau = 0; tau < TILES; ++tau) {
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[tau][i] = 0.f;
  }
  // A fragments of two k steps (a commit group), double-buffered: the
  // next pair is dequantized while this pair's wgmma run
  uint32_t fa[2][2][TILES][4];
  uint32_t sp[TILES][4];     // the group's scale operands of the lane's columns

  // The ring's slot and phase, the stage's first group and whether it ends
  // a group, kept as running counters: no division by the runtime group
  // size or ring depth in the loop.
  const int span = gs > SK ? gs / SK : 1;  // stages a group spans
  const int gstep = gs < SK ? SK / gs : 1;  // groups a stage starts
  const int spg_mask = gs >= SK ? 3 : (gs == 32 ? 1 : 0);  // k steps of a group in a stage, - 1
  const int spg_shift = gs >= SK ? 2 : (gs == 32 ? 1 : 0);
  auto wait_stage = [&](int slot, uint32_t phase) {
    wmt_async::mbar_wait(&full[slot], phase);
    wmt_async::mbar_wait(&ready[slot], phase);
  };
  auto load_scales = [&](const unsigned char* st, int g0, int gi) {
    const float* sc = reinterpret_cast<const float*>(st + L.sc);
#pragma unroll
    for (int tau = 0; tau < TILES; ++tau) {
      scale_ops<F::EIGHT>(sc[f.template aff<COLS>(cb[tau], g0, gi)],
                          sc[f.template aff<COLS>(cb[tau] + 1, g0, gi)], sp[tau]);
    }
  };
  // k steps kk, kk + 1 of the stage at st, the scales of each group as it starts
  auto dequant_pair = [&](const unsigned char* st, int g0, int kk, uint32_t (&a)[2][TILES][4]) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (((kk + q) & spg_mask) == 0) load_scales(st, g0, (kk + q) >> spg_shift);
#pragma unroll
      for (int tau = 0; tau < TILES; ++tau) {
        f.template dequant<COLS>(st + L.w, cb[tau], kk + q, t, sp[tau], a[q][tau]);
      }
    }
  };
  // xg * b of the stage's group gi into the accumulators
  auto add_bias = [&](const unsigned char* st, int g0, int gi) {
    const float* xg = reinterpret_cast<const float*>(st + L.xg) + gi * NT;
    const float* bi = reinterpret_cast<const float*>(st + L.bi);
    float2 b[TILES];
#pragma unroll
    for (int tau = 0; tau < TILES; ++tau) {
      b[tau] = make_float2(bi[f.template aff<COLS>(cb[tau], g0, gi)],
                           bi[f.template aff<COLS>(cb[tau] + 1, g0, gi)]);
    }
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const float2 xv = *reinterpret_cast<const float2*>(xg + 8 * j + 2 * t);
#pragma unroll
      for (int tau = 0; tau < TILES; ++tau) {
        acc[tau][4 * j] = fmaf(xv.x, b[tau].x, acc[tau][4 * j]);
        acc[tau][4 * j + 1] = fmaf(xv.y, b[tau].x, acc[tau][4 * j + 1]);
        acc[tau][4 * j + 2] = fmaf(xv.x, b[tau].y, acc[tau][4 * j + 2]);
        acc[tau][4 * j + 3] = fmaf(xv.y, b[tau].y, acc[tau][4 * j + 3]);
      }
    }
  };

  // At 128 rows the two warpgroups take turns on the tensor cores a stage
  // at a time (named barriers 1 and 2, the turns of warpgroups 0 and 1): a
  // warpgroup issues its stage's two pairs of k steps and hands over, then
  // waits for its products, adds the stage's xg * b and dequantizes its
  // next pair while the other's wgmma run. Fewer rows leave the tensor
  // cores idle most of the time: there the turns would only add latency.
  constexpr bool TURNS = NT == 128;
  int slot = 0, into = 0;  // the stage's slot, stages into the current group
  int held = -1;           // a slot whose last pair may still run: released at the next wait
  uint32_t phase = 0;
  int g0 = kb / gs;
  wait_stage(0, 0);
  dequant_pair(smem, g0, 0, fa[0]);
  for (int i = 0; i < ns; ++i) {
    const unsigned char* st = smem + slot * L.slot;
    into = into + 1 == span ? 0 : into + 1;
    const bool stage_end = into == 0;  // the stage ends a group
    if (TURNS && (wg == 1 || i > 0)) attn::named_sync(1 + wg, CONSUMERS);  // this warpgroup's turn
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // k steps 2h, 2h + 1: one commit group
      attn::wgmma_fence();
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint64_t db = attn::sw128_desc(st + 32 * (2 * h + q), 16, 1024);
#pragma unroll
        for (int tau = 0; tau < TILES; ++tau) wgmma_rs<NT>(acc[tau], fa[h][q][tau], db);
      }
      attn::wgmma_commit();
      if (h == 0) {
        wgmma_wait<1>();  // the last pair before this one has completed
        if (held >= 0) {
          wmt_async::mbar_arrive(&empty[held]);  // every consumer thread: no divergent branch
          held = -1;
        }
        dequant_pair(st, g0, 2, fa[1]);
      }
    }
    if (TURNS) named_arrive(2 - wg, CONSUMERS);  // the other warpgroup's turn
    if (stage_end) {
      // the stage's groups end with it (or the group that spans it): their
      // products are in, add xg * b of each
      wgmma_wait<0>();
#pragma unroll
      for (int tau = 0; tau < TILES; ++tau) attn::fence_regs(acc[tau]);
      for (int gi = 0; gi < gstep; ++gi) add_bias(st, g0, gi);
      wmt_async::mbar_arrive(&empty[slot]);
    } else {
      held = slot;
    }
    if (i + 1 < ns) {
      if (!stage_end) wgmma_wait<1>();  // the stage's first pair has completed: fa[0] is free
      slot = slot + 1 == stages ? 0 : slot + 1;
      phase ^= slot == 0;
      g0 += gs < SK ? gstep : stage_end;
      const unsigned char* nst = smem + slot * L.slot;
      wait_stage(slot, phase);
      dequant_pair(nst, g0, 0, fa[0]);
    }
  }
  if (TURNS && wg == 0) attn::named_sync(1, CONSUMERS);  // warpgroup 1's last hand-over
  wgmma_wait<0>();
#pragma unroll
  for (int tau = 0; tau < TILES; ++tau) attn::fence_regs(acc[tau]);

  // acc[tau][4j + e]: column cb[tau] + (e >> 1), row 8j + 2t + (e & 1)
  if (csize == 1) {
#pragma unroll
    for (int tau = 0; tau < TILES; ++tau) {
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        const int row = m0 + 8 * j + 2 * t;
        store_pair(out, m, n, row, n0 + cb[tau], acc[tau][4 * j], acc[tau][4 * j + 2]);
        store_pair(out, m, n, row + 1, n0 + cb[tau], acc[tau][4 * j + 1], acc[tau][4 * j + 3]);
      }
    }
    return;
  }
  // The cluster's sum through the ring (every block is past its main loop
  // after the first barrier): value e = ((wg * TILES + tau) * 128 + thread)
  // * NA + i (a thread's values neighbours, pushed 16 bytes at a time)
  // belongs to block e / slots, which sums what every block pushed into
  // its slots in block order and stores it.
  float* red = reinterpret_cast<float*>(smem);
  constexpr int EW = TILES * NA * 128;  // a warpgroup's values
  const int slots = ((2 * EW + csize - 1) / csize + 3) & ~3;
  cluster.sync();
#pragma unroll
  for (int tau = 0; tau < TILES; ++tau) {
#pragma unroll
    for (int i = 0; i < NA; i += 4) {
      const int e = ((wg * TILES + tau) * 128 + wt) * NA + i;
      *reinterpret_cast<float4*>(cluster.map_shared_rank(red, e / slots) + rank * slots + e % slots) =
          make_float4(acc[tau][i], acc[tau][i + 1], acc[tau][i + 2], acc[tau][i + 3]);
    }
  }
  cluster.sync();
  for (int j = tid; j < slots; j += CONSUMERS) {
    const int e = rank * slots + j;
    if (e < 2 * EW) {
      float sum = 0.f;
      for (int src = 0; src < csize; ++src) sum += red[src * slots + j];  // block 0 first
      const int i = e % NA, th = e / NA;  // th = (w * TILES + tau) * 128 + thread
      const int wt2 = th & 127, wtile = th >> 7;  // wtile = w * TILES + tau
      const int el = wt2 & 31, ew = wt2 >> 5;
      const int col = n0 + wtile * 64 + 16 * ew + 2 * (el >> 2) + ((i >> 1) & 1);
      const int row = m0 + 8 * (i >> 2) + 2 * (el & 3) + (i & 1);
      if (row < m && col < n) out[(size_t)row * n + col] = __float2bfloat16_rn(sum);
    }
  }
}

// The launch: K5's and K6's wmt_*_gemm. nt, cluster and stages come from
// the wrapper's plan (ops/quant_matmul.py:tiled_plan) and are checked here.
template <class F>
int launch(const void* x, F f, void* out, int m, int n, int k, int gs, int nt, int cluster,
           int stages, cudaStream_t s) {
  if (m < 1 || n < 1 || k % SK || !(gs == 16 || gs == 32 || (gs > 0 && gs % SK == 0)) || k % gs) {
    return (int)cudaErrorInvalidValue;
  }
  if (nt != 16 && nt != 32 && nt != 64 && nt != 128) return (int)cudaErrorInvalidValue;
  const int unit = gs > SK ? gs / SK : 1;
  const int units = k / SK / unit;
  if (cluster < 1 || cluster > MAX_CLUSTER || cluster > units || stages < 2 ||
      stages > MAX_STAGES) {
    return (int)cudaErrorInvalidValue;
  }
  const int cols = cols_of(nt);
  const Layout L(nt, F::WBYTES, F::aff_floats(cols, gs), gs, stages);
  const long long red =
      cluster > 1 ? 4LL * cluster * ((((2 * 64 * tiles_of(nt) * nt + cluster - 1) / cluster) + 3) & ~3) : 0;
  const dim3 grid(cluster, (m + nt - 1) / nt, (n + cols - 1) / cols);
  if (L.bytes > SMEM_LIMIT || red > (long long)L.bars || grid.y > 65535 || grid.z > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap xm;
  if (!wmt_async::tensor_map_2d(&xm, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, m, k, 2LL * k, nt, SK,
                                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !f.prepare(cols, gs)) {
    return (int)cudaErrorInvalidValue;
  }
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(out);
#define WMT_TILED(NT)                                                                    \
  wmt_async::launch_cluster<quant_gemm_kernel<F, NT>>(grid, THREADS, L.bytes, cluster, s, xm, f, \
                                                       o, m, n, k, gs, stages)
  switch (nt) {
    case 16: return (int)WMT_TILED(16);
    case 32: return (int)WMT_TILED(32);
    case 64: return (int)WMT_TILED(64);
    default: return (int)WMT_TILED(128);
  }
#undef WMT_TILED
}

}  // namespace tiled

}  // namespace wmt_quant
