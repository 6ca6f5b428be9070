// Grouped-query attention over the quantized LLM KV cache for Hopper
// (sm_90a): kernel K3's GQA mode.
//
// Replaces: whisper_mlx_tpu/models/qwen.py:289-300, the reference's grouped
// path over an int8 / int4 cache (XLA on the TPU, no Pallas kernel), with
// per-row positions (continuous batching, qwen.py:182-194) and blocks of
// several query positions past 0 (speculative decoding's verify and draft
// sync).
//
// Layout (position-major, models/qwen.py:init_kv_cache):
//   q      (B, KV * rep, Tq, hd) fp32, rotated and normed, not pre-scaled
//   codes  (B, KV, T_alloc, hd) int8, or (B, KV, T_alloc, hd / 2) uint8
//          holding two signed int4 nibbles a byte (low nibble = even d)
//   scales (B, KV, T_alloc) bf16
//   pos    (B,) int32 on the device
// Query head h reads KV head h / rep. Row b's query i attends keys
// t <= pos[b] + i and t < live (a first position at or past the cache end
// reads every key):
//   s_t = (q . k_t) * (ks_t * scale) in fp32; w = softmax(s);
//   out = sum_t (w_t vs_t) v_t in fp32 -> fp32 or bf16
//
// What bounds it on the H100: device-memory bytes. A decode step reads each
// live code once: Qwen3-32B's 8 KV heads x 128 dims, K and V, int8 (int4)
// plus a bf16 scale each, 4,128 (2,080) B a position a layer, 2.5 us at
// 4,096 keys. Both products run on the tensor cores, where their operations
// (the split query and weights make 2 x 2 products a code and query row)
// take a fraction of that. What costs the time is each code's way from
// shared memory into an mma's registers (the unpacking is most of a tile's
// instructions), a block's fixed chain (the first slot's arrival, the
// merges) and placing the blocks: the first form's fp32 SIMT products, four
// block barriers a 64-key tile and at most 8 blocks a head gave 10 % of the
// bound.
//
// Design (the launch plan is Python, ops/gqa_decode_attention.py:gqa_plan):
// - A thread-block cluster of C blocks (1 to 16; past 8 a non-portable
//   cluster) serves one (batch row, KV head, pass of 8 query rows): the
//   rep x Tq query rows of a KV head, padded to a multiple of 8, are the
//   mma's n, one n8 tile a pass, and the passes are blocks of the grid.
//   Block r takes keys [r L / C, (r + 1) L / C) of the row's own L =
//   min(pos[b] + Tq, live). The plan takes the largest C of 16, 8, 4 whose
//   clusters the card holds all at once at one block an SM (a wide ring,
//   cudaOccupancyMaxActiveClusters), else about 4/3 of the SMs' blocks in
//   all at two an SM: the H100 holds 7 clusters of 16 at one block an SM,
//   and at two it packs two blocks of a cluster onto one SM, either way
//   slower than 8 clusters of 8 at B = 1.
// - A producer warp keeps a ring of `stages` slots of 128 keys in flight
//   from the block's start: the keys' K and V codes by cp.async.bulk (one
//   copy each), their scales as the 16-byte-aligned window around them by
//   16-byte cp.async from its 32 lanes (a piece past the tensor's end reads
//   only what is there), all completing on the slot's full mbarrier; it
//   refills a slot once its empty mbarrier has seen the 8 consumer warps.
//   Meanwhile the consumers stage the pass's query rows in shared memory as
//   the mma's B fragments: each row scaled by a power of two into fp16's
//   range and split into fp16 parts hi + lo, 11 bits each.
// - Consumer warp w takes the 16-key tile w of every slot and keeps its own
//   running max, sum and output fragments in registers across tiles: no
//   block barrier inside the key loop, and the next tile's QK issued before
//   this one's softmax and PV. QK: S^T (16 keys x 8 rows) on mma.sync
//   m16n8k16, fp16 in, fp32 out, the codes as A exactly (int8: an xor, a
//   byte permute under the fp16 exponent of 1024 and one fp16x2 add a pair;
//   int4: one lop3 and one add), four accumulator chains. The softmax is
//   fp32 in log2 units: each row's tile max across the 8 lanes that hold
//   it, ex2 and the earlier tiles' correction (skipped when no row's max
//   moved). The weights exp(s - m) vs_t, times a power of two a warp that
//   keeps them in fp16's range (lowered as larger scales come, the outputs
//   kept so far lowered with it), split into fp16 hi + lo, are transposed
//   into PV's B fragments by movmatrix; PV: O^T (16 dims x 8 rows) += V^T
//   W^T on mma.sync fp16, the V codes as A exactly (pairs of keys by a
//   byte permute, then one lop3 and one fp16x2 add).
// - After the loop the warps merge in warp order through shared memory (the
//   ring's, every copy landed); every block pushes its rows' max and sum to
//   every block of the cluster and each output element, scaled to its own
//   max, to the block that owns it (distributed shared memory; the first
//   push waits on the cluster barrier every block arrived on at its start),
//   and after one cluster barrier each owner combines them in block order
//   and writes. No atomics and a fixed order everywhere: a repeat is
//   bit-equal.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include "sm90_async.cuh"

namespace {

using namespace wmt_async;

constexpr int CONSUMERS = 8;                   // consumer warps: a 16-key tile each a slot
constexpr int THREADS = (CONSUMERS + 1) * 32;  // and the producer warp
constexpr int ROWS = 8;                        // query rows a pass: the mma's n
constexpr int TILE = 16;                       // keys a warp's tile: the mma's m
constexpr int SK = CONSUMERS * TILE;           // keys a slot of the ring
constexpr int SCALE_SLOT = (SK + 8) * 2;       // a slot's scales from an aligned start
constexpr int MAX_BLOCKS = 16;                 // blocks a cluster (8 is the portable size)
constexpr int MAX_STAGES = 8;
constexpr int RING_BYTES = 200000;             // the widest ring: 6 slots of int8 hd 128
constexpr int QP = 2;                          // fp16 parts of the query: hi + lo
constexpr int WP = 2;                          // and of the weights
constexpr int RED_STRIDE_PAD = 1;              // a row of the warps' outputs: HD + 1 floats
constexpr int EW_MAX = 120;                    // the weights' exponent stays in [-120, 120]
constexpr int MAX_TQ = 16;
constexpr int MAX_T = 32768;
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t FULL_ARRIVALS = 1 + 32;     // lane 0's expect_tx, every lane's cp.async

// The codes as exact fp16x2 pairs for the mma (fp16 holds every int8 code:
// 0x6400 | u is 1024 + u, its ulp 1). QK's int8: two bytes of a word, offset
// to u = c + 128 by an xor, placed under 0x64 by one byte permute, and one
// fp16x2 add of -1152; PV's int8: two keys' bytes paired by a byte permute,
// then one lop3 (mask, the xor and 0x64 at once) and the add; int4: a nibble
// pair as 1024 + (n ^ 8) by one lop3 and an add of -1032.
constexpr uint32_t F16_1024X2 = 0x64646464u;   // the high bytes of 1024 + u
constexpr uint32_t F16_M1152 = 0xE480E480u;    // (-1152, -1152)
constexpr uint32_t F16_M1032 = 0xE408E408u;    // (-1032, -1032)

__device__ __forceinline__ uint32_t f16x2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.f16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// bytes i and j of w (xored to u = c + 128) as the fp16x2 pair (c_i, c_j)
template <int SEL>
__device__ __forceinline__ uint32_t byte_pair_f16(uint32_t wx) {
  return f16x2_add(__byte_perm(wx, F16_1024X2, SEL), F16_M1152);
}

// bytes 0 and 2 of x (raw codes) as the fp16x2 pair of their codes
__device__ __forceinline__ uint32_t byte_pair_f16_raw(uint32_t x) {
  uint32_t p;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;" : "=r"(p) : "r"(x), "n"(0x00FF00FF), "r"(0x64806480));
  return f16x2_add(p, F16_M1152);
}

__device__ __forceinline__ uint32_t nibble_pair_f16(uint32_t x) {  // int4 codes
  uint32_t p;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;" : "=r"(p) : "r"(x), "n"(0x000F000F), "r"(0x64086408));
  return f16x2_add(p, F16_M1032);
}

// c += a @ b for one m16n8k16 tile, fp16 in, fp32 accumulate (mma_16816's
// register layout)
__device__ __forceinline__ void mma_16816_f16(float (&c)[4], uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 2^e exactly, |e| < 127
__device__ __forceinline__ float pow2(int e) { return __int_as_float((e + 127) << 23); }

// 2^x (ex2.approx.ftz: 2 ulp, 0 for -inf)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct Layout {
  int stage, ks, vs, qf, qsc, red, wstat, stat, fac, pout, bars, total;
};

// Byte offsets into dynamic shared memory (mirrored by
// ops/gqa_decode_attention.py:gqa_smem): the ring's slots (K codes, V codes,
// their scales' windows), which the warps' outputs take over once every
// tile is read; the pass's query rows as the mma's B fragments (QP fp16
// parts) and each row's power-of-two scale, the warps' (max, sum) of each
// row, the (max, sum) every block pushes, each block's factor of each row,
// the outputs pushed to this block and the barriers.
__host__ __device__ inline int stage_bytes(int hd, int bits) {
  return 2 * SK * (hd * bits / 8) + 2 * SCALE_SLOT;
}

__host__ __device__ inline Layout layout(int hd, int bits, int stages) {
  Layout l;
  l.stage = stage_bytes(hd, bits);
  l.ks = 2 * SK * (hd * bits / 8);
  l.vs = l.ks + SCALE_SLOT;
  l.red = 0;
  const int ring = stages * l.stage;
  const int red = (CONSUMERS * ROWS * (hd + RED_STRIDE_PAD) * 4 + 15) & ~15;
  int off = ring > red ? ring : red;
  l.qf = off;
  off += QP * ROWS * hd * 2;
  l.qsc = off;
  off += ROWS * 4;
  l.wstat = off;
  off += CONSUMERS * ROWS * 2 * 4;
  l.stat = off;
  off += MAX_BLOCKS * ROWS * 2 * 4;
  l.fac = off;
  off += MAX_BLOCKS * ROWS * 4;
  l.pout = off;
  off += (ROWS * hd + MAX_BLOCKS) * 4;
  l.bars = off;
  off += 2 * MAX_STAGES * 8;
  l.total = off;
  return l;
}

// an 8 x 8 matrix of 16-bit values, a row of two values a quad of lanes,
// transposed across the warp
__device__ __forceinline__ uint32_t transpose8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// barrier `id` (not 0, __syncthreads') among `count` threads
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// (x0, x1) as P fp16x2 parts whose sum is (x0, x1) to about 11 P bits:
// each part the residual of the ones before (exact in fp32) rounded to fp16
// (x0 and x1 already scaled so that no part overflows)
template <int P>
__device__ __forceinline__ void split_pair_f16(float x0, float x1, uint32_t (&part)[P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const __half2 h = __floats2half2_rn(x0, x1);
    part[p] = *reinterpret_cast<const uint32_t*>(&h);
    x0 -= __low2float(h);
    x1 -= __high2float(h);
  }
}

__device__ __forceinline__ float bf16_at(const unsigned char* p, int i) {
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
}

template <int HD, int BITS>
__global__ void __launch_bounds__(THREADS, 2)
gqa_attn_kernel(const float* __restrict__ q, const uint8_t* __restrict__ k,
                const __nv_bfloat16* __restrict__ ks, const uint8_t* __restrict__ v,
                const __nv_bfloat16* __restrict__ vs, const int* __restrict__ pos,
                void* __restrict__ out, int n_kv, int rep, int tq, int t_alloc, int live,
                float scale, int out_bf16, long long scale_count, int passes, int stages) {
  constexpr int ROWB = HD * BITS / 8;  // bytes of a key's codes
  constexpr int NCH = HD / 64;         // 64-dim chunks: a quad of lanes covers one
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay = layout(HD, BITS, stages);
  uint32_t* qf = reinterpret_cast<uint32_t*>(smem + lay.qf);
  float* qscale = reinterpret_cast<float*>(smem + lay.qsc);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  float* wstat = reinterpret_cast<float*>(smem + lay.wstat);
  float* stat = reinterpret_cast<float*>(smem + lay.stat);
  float* fac = reinterpret_cast<float*>(smem + lay.fac);
  float* pout = reinterpret_cast<float*>(smem + lay.pout);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + MAX_STAGES;

  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int warp = __shfl_sync(FULL, tid >> 5, 0);
  const int lane = tid & 31;
  const int g = blockIdx.y / passes;  // the KV head
  const int pass = blockIdx.y % passes;
  const int b = blockIdx.z;
  const int n_rows = rep * tq;  // the KV head's query rows: rep heads x tq steps
  const int r0 = pass * ROWS;
  const int p0 = max(pos[b], 0);
  // the row's live keys, split evenly over the cluster
  const int row_live = min(p0 + tq, live);
  const int t0 = (int)((long long)rank * row_live / csize);
  const int t1 = (int)((long long)(rank + 1) * row_live / csize);
  const int n_keys = t1 - t0;
  const long long kv = (long long)b * n_kv + g;
  const uint8_t* kb = k + kv * t_alloc * ROWB;
  const uint8_t* vb = v + kv * t_alloc * ROWB;
  const long long sbase = kv * t_alloc;
  const long long qbase = kv * rep * tq * HD;  // the KV head's first query row
  constexpr int RS = HD + RED_STRIDE_PAD;       // a row of the warps' outputs
  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units: exp2 below

  cluster_arrive_relaxed();  // waited before the first write into another block
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], FULL_ARRIVALS);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int gq = lane >> 2;  // the mma's group: a key of S^T, a dim of O^T, a row of B
  const int cq = lane & 3;   // and its quad index: rows 2 cq, 2 cq + 1 of C
  float m[2] = {-INFINITY, -INFINITY};  // rows 2 cq, 2 cq + 1: running max
  float l[2] = {0.f, 0.f};              // this lane's share of the running sum
  int ew = EW_MAX;                      // the warp's weights and outputs times 2^ew
  float acc[NCH][4][4];                 // O^T: dims 64 c + 8 gq + 2 tt (+1), rows 2 cq (+1)
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[c][tt][i] = 0.f;
    }
  }

  if (warp == CONSUMERS) {
    // the producer: slot after slot of 128 keys, `stages` ahead of the
    // consumers
    const int n_slots = (n_keys + SK - 1) / SK;
    for (int st = 0; st < n_slots; ++st) {
      const int s = st % stages;
      if (st >= stages) mbar_wait(&empty[s], ((st / stages) - 1) & 1);
      unsigned char* slot = smem + s * lay.stage;
      const int ta = t0 + st * SK;
      const int cnt = min(SK, t1 - ta);
      if (lane == 0) {
        fence_proxy_async();  // the consumers' reads of the slot before the copies' writes
        mbar_expect_tx(&full[s], 2u * cnt * ROWB);
        bulk_load(slot, kb + (long long)ta * ROWB, cnt * ROWB, &full[s]);
        bulk_load(slot + SK * ROWB, vb + (long long)ta * ROWB, cnt * ROWB, &full[s]);
      }
      // the scales' 16-byte-aligned window, a piece a lane; a piece past the
      // tensor's last element reads only the elements before it
      const long long first = sbase + ta;
      const long long sa = first & ~7LL;
      const int pieces = (int)((first + cnt - sa + 7) / 8);
      for (int pc = lane; pc < 2 * pieces; pc += 32) {
        const bool is_v = pc >= pieces;
        const int pp = is_v ? pc - pieces : pc;
        const long long e = sa + 8LL * pp;
        const int nbytes = (int)min(16LL, 2 * (scale_count - e));
        cp_async16_part(slot + (is_v ? lay.vs : lay.ks) + 16 * pp, (is_v ? vs : ks) + e, nbytes);
      }
      cp_async_mbar_arrive(&full[s]);
    }
  } else {
    // the pass's query rows as the mma's B fragments, in QP fp16 parts, rows
    // past the last zeros: a thread takes 8 dims (two float4 when q is
    // 16-byte aligned) of a row, the words (dim pairs) of one lane's half of
    // a chunk, in the order its k steps take the codes (int8: dims 4 st,
    // 4 st + 2 then 4 st + 1, 4 st + 3 of its 16; int4: 8 j + i, 8 j + i + 4
    // for i = 0..3 of its 8-dim group j). Word w of part p, chunk c, half h
    // for lane L = 4 row + cq sits at qf[(((p NCH + c) 2 + h) 32 + L) 4 + w]:
    // a lane's 16 bytes of a half next to its neighbours'.
    {
      const bool aligned = (reinterpret_cast<uintptr_t>(q) & 15) == 0;
      for (int e = tid; e < ROWS * HD / 8; e += CONSUMERS * 32) {
        const int r = e / (HD / 8);
        const int u = e % (HD / 8);  // dims 8 u .. 8 u + 7
        float x[8];
        if (r0 + r < n_rows) {
          const float* src = q + qbase + (long long)(r0 + r) * HD + 8 * u;
          if (aligned) {
            const float4 a = *reinterpret_cast<const float4*>(src);
            const float4 c4 = *reinterpret_cast<const float4*>(src + 4);
            x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
            x[4] = c4.x, x[5] = c4.y, x[6] = c4.z, x[7] = c4.w;
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i) x[i] = src[i];
          }
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) x[i] = 0.f;
        }
        // the row's largest |q| over its HD / 8 threads (neighbouring lanes),
        // and a power of two that brings it to [2^13, 2^14): the fp16 parts
        // neither overflow nor lose the row's small elements
        float amax = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(x[i]));
#pragma unroll
        for (int off = HD / 16; off > 0; off >>= 1) {
          amax = fmaxf(amax, __shfl_xor_sync(FULL, amax, off));
        }
        int ex = 0;
        frexpf(amax, &ex);  // amax < 2^ex
        const int shift = amax > 0.f ? min(max(14 - ex, -100), 100) : 0;
        if (u == 0) qscale[r] = ldexpf(1.f, -shift);
        uint32_t words[4][QP];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          // int8: (0, 2), (1, 3), (4, 6), (5, 7); int4: (0, 4), (1, 5), (2, 6), (3, 7)
          const int a = BITS == 8 ? 4 * (w >> 1) + (w & 1) : w;
          split_pair_f16<QP>(ldexpf(x[a], shift), ldexpf(x[a + (BITS == 8 ? 2 : 4)], shift),
                             words[w]);
        }
        const int c = u / 8;
        const int L = 4 * r + (u % 8) / 2;
        const int h = u % 2;
#pragma unroll
        for (int p = 0; p < QP; ++p) {
          *reinterpret_cast<uint4*>(qf + (((p * NCH + c) * 2 + h) * 32 + L) * 4) =
              make_uint4(words[0][p], words[1][p], words[2][p], words[3][p]);
        }
      }
    }
    named_barrier_sync(1, CONSUMERS * 32);  // the consumers' query fragments are in place
    // each of this lane's rows: its keys t < lim (causal at its step, the
    // block's slice)
    int lim[2];
    float rowscale[2];  // 2^-shift of each row: its scores' true scale
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int rr = r0 + 2 * cq + j;  // head rr / tq's step rr % tq
      lim[j] = min(min(p0 + rr % tq + 1, live), t1);
      rowscale[j] = qscale[2 * cq + j];
    }

    const int n_tiles = (n_keys + TILE - 1) / TILE;
    const int lk = warp * TILE + gq;  // this lane's keys of a slot: lk, lk + 8
    // QK of the warp's tile in ring slot si into sk
    auto qk = [&](int si, float (&sk)[4][4]) {
      const unsigned char* slot = smem + si * lay.stage;
      // QK: S^T += K Q^T, keys lk (rows gq of A) and lk + 8 (gq + 8), in
      // four independent accumulator chains (a query part and a k step's
      // parity) summed in a fixed order after
#pragma unroll
      for (int a = 0; a < 4; ++a) sk[a][0] = sk[a][1] = sk[a][2] = sk[a][3] = 0.f;
      {
        const unsigned char* k0 = slot + lk * ROWB;
        const unsigned char* k1 = k0 + 8 * ROWB;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          uint32_t bq[QP][8];  // this lane's B words of the chunk, each part
#pragma unroll
          for (int p = 0; p < QP; ++p) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint4 w4 =
                  *reinterpret_cast<const uint4*>(qf + (((p * NCH + c) * 2 + h) * 32 + lane) * 4);
              bq[p][4 * h] = w4.x, bq[p][4 * h + 1] = w4.y;
              bq[p][4 * h + 2] = w4.z, bq[p][4 * h + 3] = w4.w;
            }
          }
          if constexpr (BITS == 8) {
            const uint4 u0 = *reinterpret_cast<const uint4*>(k0 + 64 * c + 16 * cq);
            const uint4 u1 = *reinterpret_cast<const uint4*>(k1 + 64 * c + 16 * cq);
            const uint32_t w0[4] = {u0.x ^ 0x80808080u, u0.y ^ 0x80808080u,
                                    u0.z ^ 0x80808080u, u0.w ^ 0x80808080u};
            const uint32_t w1[4] = {u1.x ^ 0x80808080u, u1.y ^ 0x80808080u,
                                    u1.z ^ 0x80808080u, u1.w ^ 0x80808080u};
#pragma unroll
            for (int st4 = 0; st4 < 4; ++st4) {
              // dims (0, 2) of the word's four at k 2 cq, 2 cq + 1; (1, 3) at + 8
              const uint32_t a0 = byte_pair_f16<0x4240>(w0[st4]);
              const uint32_t a1 = byte_pair_f16<0x4240>(w1[st4]);
              const uint32_t a2 = byte_pair_f16<0x4341>(w0[st4]);
              const uint32_t a3 = byte_pair_f16<0x4341>(w1[st4]);
#pragma unroll
              for (int p = 0; p < QP; ++p) {
                mma_16816_f16(sk[(2 * p + (st4 & 1)) & 3], a0, a1, a2, a3, bq[p][2 * st4],
                              bq[p][2 * st4 + 1]);
              }
            }
          } else {
            const uint2 u0 = *reinterpret_cast<const uint2*>(k0 + 32 * c + 8 * cq);
            const uint2 u1 = *reinterpret_cast<const uint2*>(k1 + 32 * c + 8 * cq);
            const uint32_t w0[2] = {u0.x, u0.y};
            const uint32_t w1[2] = {u1.x, u1.y};
#pragma unroll
            for (int st4 = 0; st4 < 4; ++st4) {
              const int j = st4 >> 1;
              const int sh = 8 * (st4 & 1);
              const uint32_t a0 = nibble_pair_f16(w0[j] >> sh);
              const uint32_t a1 = nibble_pair_f16(w1[j] >> sh);
              const uint32_t a2 = nibble_pair_f16(w0[j] >> (sh + 4));
              const uint32_t a3 = nibble_pair_f16(w1[j] >> (sh + 4));
#pragma unroll
              for (int p = 0; p < QP; ++p) {
                mma_16816_f16(sk[(2 * p + (st4 & 1)) & 3], a0, a1, a2, a3, bq[p][2 * st4],
                              bq[p][2 * st4 + 1]);
              }
            }
          }
        }
      }
    };
    // the softmax and PV of the warp's tile of the block's slot st, in ring
    // slot si, then the slot is released
    auto attend = [&](int st, int si, const float (&sk)[4][4]) {
      const unsigned char* slot = smem + si * lay.stage;
      const int ta = t0 + st * SK;               // the slot's first key
      const int soff = (int)((sbase + ta) & 7);  // its scale in the window
      const int tk = ta + lk;
      float sc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[i] = (sk[0][i] + sk[1][i]) + (sk[2][i] + sk[3][i]);

      // the online softmax in fp32: sc holds keys tk (0, 1) and tk + 8 (2,
      // 3) at rows 2 cq (0, 2) and 2 cq + 1 (1, 3); a row's tile max across
      // the 8 lanes of its quad index
      const float kscale[2] = {bf16_at(slot + lay.ks, soff + lk) * sl2,
                               bf16_at(slot + lay.ks, soff + lk + 8) * sl2};
      const float vscale[2] = {bf16_at(slot + lay.vs, soff + lk),
                               bf16_at(slot + lay.vs, soff + lk + 8)};
      float wgt[4], corr[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool in0 = tk < lim[j];
        const bool in1 = tk + 8 < lim[j];
        const float s0 = in0 ? sc[j] * rowscale[j] * kscale[0] : -INFINITY;
        const float s1 = in1 ? sc[j + 2] * rowscale[j] * kscale[1] : -INFINITY;
        float mx = fmaxf(s0, s1);
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 16));
        const float mnew = fmaxf(m[j], mx);
        float e0 = 0.f, e1 = 0.f;
        corr[j] = 1.f;
        if (mnew != -INFINITY) {  // never exp(-inf - -inf)
          corr[j] = fast_exp2(m[j] - mnew);
          e0 = fast_exp2(s0 - mnew);
          e1 = fast_exp2(s1 - mnew);
        }
        m[j] = mnew;
        l[j] = l[j] * corr[j] + (e0 + e1);
        // the weights exp(s - m) vs; 0 past the row's keys, where the slot
        // may hold no scale
        wgt[j] = in0 ? e0 * vscale[0] : 0.f;
        wgt[j + 2] = in1 ? e1 * vscale[1] : 0.f;
      }
      // the weights into fp16's range: times 2^ew, ew the warp's exponent,
      // lowered (never raised) to keep its tile's largest scale below 2^14
      // (a weight is at most its key's scale); the outputs kept so far follow
      // (the scales are positive: their bits order as unsigned integers)
      const uint32_t vbits = __reduce_max_sync(
          FULL, max(tk < t1 ? __float_as_uint(vscale[0]) : 0u,
                    tk + 8 < t1 ? __float_as_uint(vscale[1]) : 0u));
      float lower = 1.f;
      if (vbits >= (1u << 23)) {  // a normal scale: below 2^(e - 126), e its biased exponent
        const int ew_tile = max(min(140 - (int)(vbits >> 23), EW_MAX), -EW_MAX);
        if (ew_tile < ew) {
          lower = pow2(ew_tile - ew);
          ew = ew_tile;
        }
      }
      // the earlier tiles' outputs to the new max and exponent, unless
      // neither moved
      const float c0 = corr[0] * lower, c1 = corr[1] * lower;
      if (!__all_sync(FULL, c0 == 1.f && c1 == 1.f)) {
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
#pragma unroll
          for (int tt = 0; tt < 4; ++tt) {
            acc[c][tt][0] *= c0;
            acc[c][tt][1] *= c1;
            acc[c][tt][2] *= c0;
            acc[c][tt][3] *= c1;
          }
        }
      }
      // PV's B (16 keys x 8 rows, col-major: a lane row gq's keys 2 cq,
      // 2 cq + 1 and 2 cq + 8, 2 cq + 9): the scaled weights split into
      // fp16 hi + lo, each 8 x 8 half transposed from S^T's layout
      uint32_t bw[WP][2];  // [hi, lo][keys 0-7, 8-15]
      {
        const float sw = pow2(ew);
        uint32_t p01[WP], p23[WP];
        split_pair_f16<WP>(wgt[0] * sw, wgt[1] * sw, p01);
        split_pair_f16<WP>(wgt[2] * sw, wgt[3] * sw, p23);
#pragma unroll
        for (int p = 0; p < WP; ++p) {
          bw[p][0] = transpose8x8(p01[p]);
          bw[p][1] = transpose8x8(p23[p]);
        }
      }

      // PV: O^T += V^T W^T. Lane (gq, cq) holds A of dims 64 c + 8 gq ..
      // + 7 (dim tile tt: 8 gq + 2 tt as row gq, + 1 as row gq + 8) at keys
      // 2 cq, 2 cq + 1 and 2 cq + 8, 2 cq + 9 of the tile, paired across
      // two key rows by a byte permute
      {
        const unsigned char* vt = slot + SK * ROWB + warp * TILE * ROWB;
        const int keys[4] = {2 * cq, 2 * cq + 1, 2 * cq + 8, 2 * cq + 9};
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          if constexpr (BITS == 4) {
            uint32_t w[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              w[e] = *reinterpret_cast<const uint32_t*>(vt + keys[e] * ROWB + 32 * c + 4 * gq);
            }
#pragma unroll
            for (int tt = 0; tt < 4; ++tt) {  // byte tt: dims 8 gq + 2 tt, + 1
              const uint32_t sel = (uint32_t)tt | ((uint32_t)(4 + tt) << 8);
              const uint32_t p01 = __byte_perm(w[0], w[1], sel);
              const uint32_t p89 = __byte_perm(w[2], w[3], sel);
              const uint32_t a0 = nibble_pair_f16(p01), a1 = nibble_pair_f16(p01 >> 4);
              const uint32_t a2 = nibble_pair_f16(p89), a3 = nibble_pair_f16(p89 >> 4);
#pragma unroll
              for (int p = 0; p < WP; ++p) {
                mma_16816_f16(acc[c][tt], a0, a1, a2, a3, bw[p][0], bw[p][1]);
              }
            }
          } else {
            uint2 w[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              w[e] = *reinterpret_cast<const uint2*>(vt + keys[e] * ROWB + 64 * c + 8 * gq);
            }
#pragma unroll
            for (int tt = 0; tt < 4; ++tt) {  // bytes 2 tt (dim 8 gq + 2 tt) and 2 tt + 1
              const int bb = 2 * (tt & 1);
              const uint32_t sa = (uint32_t)bb | ((uint32_t)(4 + bb) << 8);
              const uint32_t sb = (uint32_t)(bb + 1) | ((uint32_t)(5 + bb) << 8);
              const uint32_t x0 = tt < 2 ? w[0].x : w[0].y, x1 = tt < 2 ? w[1].x : w[1].y;
              const uint32_t x8 = tt < 2 ? w[2].x : w[2].y, x9 = tt < 2 ? w[3].x : w[3].y;
              const uint32_t pa = __byte_perm(x0, x1, sa), pb = __byte_perm(x0, x1, sb);
              const uint32_t qa = __byte_perm(x8, x9, sa), qb = __byte_perm(x8, x9, sb);
              const uint32_t a0 = byte_pair_f16_raw(pa), a1 = byte_pair_f16_raw(pb);
              const uint32_t a2 = byte_pair_f16_raw(qa), a3 = byte_pair_f16_raw(qb);
#pragma unroll
              for (int p = 0; p < WP; ++p) {
                mma_16816_f16(acc[c][tt], a0, a1, a2, a3, bw[p][0], bw[p][1]);
              }
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[si]);  // this warp has read its tile
    };
    // tile after tile, the next tile's QK before this one's softmax and PV
    // (its products overlap them): one call site of each, QK a step ahead.
    // The next slot is never the one held: the ring has 2 slots or more
    // wherever a block has 2 slots of keys or more.
    float ska[4][4], skb[4][4];
    int si = 0, si_next = 0;  // ring slots of tiles st and st + 1
    uint32_t parity = 0;      // the phase of slot si_next that holds tile st + 1
    for (int i = warp - CONSUMERS, st = -1;; i += CONSUMERS, ++st) {
      const bool next = i + CONSUMERS < n_tiles;
      if (next) {
        mbar_wait(&full[si_next], parity);
        qk(si_next, skb);
      }
      if (st >= 0) attend(st, si, ska);
      if (!next) break;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ska[a][e] = skb[a][e];
      }
      si = si_next;
      if (++si_next == stages) {
        si_next = 0;
        parity ^= 1;
      }
    }

    // the warp's (max, sum) of each row: the sum over its 8 lanes of a quad
    // index
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      l[j] += __shfl_xor_sync(FULL, l[j], 4);
      l[j] += __shfl_xor_sync(FULL, l[j], 8);
      l[j] += __shfl_xor_sync(FULL, l[j], 16);
      if (gq == 0) {
        wstat[(warp * ROWS + 2 * cq + j) * 2] = m[j];
        wstat[(warp * ROWS + 2 * cq + j) * 2 + 1] = l[j];
      }
    }
  }
  __syncthreads();
  // every copy into the ring has landed (each slot's full barrier was waited
  // on by the warp of its first tile): the warps' outputs take it over
  fence_proxy_async();

  // each warp's outputs scaled to the block's max of each row
  if (warp < CONSUMERS) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = 2 * cq + j;
      float mb = -INFINITY;
      for (int w = 0; w < CONSUMERS; ++w) mb = fmaxf(mb, wstat[(w * ROWS + r) * 2]);
      const float f = m[j] != -INFINITY ? fast_exp2(m[j] - mb) * pow2(-ew) : 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
#pragma unroll
        for (int tt = 0; tt < 4; ++tt) {
          const int d = 64 * c + 8 * gq + 2 * tt;
          red[(warp * ROWS + r) * RS + d] = acc[c][tt][j] * f;
          red[(warp * ROWS + r) * RS + d + 1] = acc[c][tt][j + 2] * f;
        }
      }
    }
  }
  __syncthreads();

  // the block's (max, sum) of each row to every block of the cluster, its
  // outputs (the warps' in warp order) to the block that owns each: output
  // e = r * HD + d belongs to block e % C
  const int nr = min(ROWS, n_rows - r0);
  const int n_out = nr * HD;
  const int slots = (n_out + csize - 1) / csize;
  cluster_wait();  // every block of the cluster has started
  for (int e = tid; e < nr * csize; e += THREADS) {
    const int r = e / csize;
    float mb = -INFINITY;
    for (int w = 0; w < CONSUMERS; ++w) mb = fmaxf(mb, wstat[(w * ROWS + r) * 2]);
    float lb = 0.f;
    for (int w = 0; w < CONSUMERS; ++w) {
      const float lw = wstat[(w * ROWS + r) * 2 + 1];
      if (lw > 0.f) lb += lw * fast_exp2(wstat[(w * ROWS + r) * 2] - mb);
    }
    float* dst = cluster.map_shared_rank(stat, e % csize) + (rank * ROWS + r) * 2;
    dst[0] = mb;
    dst[1] = lb;
  }
  for (int e = tid; e < n_out; e += THREADS) {
    const int at = (e / HD) * RS + e % HD;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < CONSUMERS; ++w) o += red[w * ROWS * RS + at];
    cluster.map_shared_rank(pout, e % csize)[rank * slots + e / csize] = o;
  }
  cluster.sync();
  // each block's factor of each row, exp2(m_block - m) / l with the
  // cluster's max m and sum l (summed in block order); then each owner sums
  // its outputs times the factors in block order
  for (int e = tid; e < nr * csize; e += THREADS) {
    const int r = e / csize;
    const int src = e % csize;
    float mx = -INFINITY;
    for (int x = 0; x < csize; ++x) mx = fmaxf(mx, stat[(x * ROWS + r) * 2]);
    float lsum = 0.f;
    for (int x = 0; x < csize; ++x) {  // block 0 first: a fixed order
      const float ms = stat[(x * ROWS + r) * 2];
      if (ms != -INFINITY) lsum += stat[(x * ROWS + r) * 2 + 1] * fast_exp2(ms - mx);
    }
    const float ms = stat[(src * ROWS + r) * 2];
    fac[src * ROWS + r] = ms != -INFINITY ? fast_exp2(ms - mx) / lsum : 0.f;
  }
  __syncthreads();
  for (int slot = tid; slot < slots; slot += THREADS) {
    const int e = slot * csize + rank;
    if (e >= n_out) break;
    const int r = e / HD;
    float o = 0.f;
    for (int src = 0; src < csize; ++src) o += pout[src * slots + slot] * fac[src * ROWS + r];
    const long long at = qbase + (long long)r0 * HD + e;
    if (out_bf16) {
      reinterpret_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16(o);
    } else {
      reinterpret_cast<float*>(out)[at] = o;
    }
  }
}

// Allow Kernel clusters past the portable 8 blocks, once a device.
template <auto Kernel>
cudaError_t allow_wide_cluster() {
  static bool allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < MAX_DEVICES && allowed[dev])) return e;
  e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess && dev < MAX_DEVICES) allowed[dev] = true;
  return e;
}

template <int HD, int BITS>
cudaError_t launch(dim3 grid, int blocks, int stages, cudaStream_t s, const void* q,
                   const void* k, const void* ks, const void* v, const void* vs, const void* pos,
                   void* out, int n_kv, int rep, int tq, int t_alloc, int live, float scale,
                   int out_bf16, long long scale_count, int passes) {
  const cudaError_t e = allow_wide_cluster<gqa_attn_kernel<HD, BITS>>();
  if (e != cudaSuccess) return e;
  return launch_cluster<gqa_attn_kernel<HD, BITS>>(
      grid, THREADS, layout(HD, BITS, stages).total, blocks, s, (const float*)q,
      (const uint8_t*)k, (const __nv_bfloat16*)ks, (const uint8_t*)v, (const __nv_bfloat16*)vs,
      (const int*)pos, out, n_kv, rep, tq, t_alloc, live, scale, out_bf16, scale_count, passes,
      stages);
}

// The room for clusters of `blocks` on the device: active clusters at once.
template <int HD, int BITS>
cudaError_t cluster_room(int blocks, int stages, int* room) {
  const int smem = layout(HD, BITS, stages).total;
  cudaError_t e = allow_wide_cluster<gqa_attn_kernel<HD, BITS>>();
  if (e == cudaSuccess) e = allow_smem<gqa_attn_kernel<HD, BITS>>(smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(room, gqa_attn_kernel<HD, BITS>, &cfg);
}

bool plan_ok(int hd, int bits, int blocks, int rows, int stages) {
  return (hd == 64 || hd == 128) && (bits == 4 || bits == 8) && blocks >= 1 &&
         blocks <= MAX_BLOCKS && rows == ROWS && stages >= 1 && stages <= MAX_STAGES &&
         stages * stage_bytes(hd, bits) <= RING_BYTES;
}

}  // namespace

// K3's GQA mode on the plan of ops/gqa_decode_attention.py:gqa_plan (blocks
// a (row, KV head, pass), rows a pass, ring stages).
extern "C" int wmt_gqa_decode_attention(const void* q, const void* k, const void* ks,
                                        const void* v, const void* vs, const void* pos,
                                        void* out, int b, int n_kv, int rep, int tq, int hd,
                                        int t_alloc, int live, int bits, float scale,
                                        int out_bf16, int blocks, int rows, int stages,
                                        void* stream) {
  const int passes = (rep * tq + ROWS - 1) / ROWS;
  if (b < 1 || b > 65535 || n_kv < 1 || rep < 1 || tq < 1 || tq > MAX_TQ ||
      (long long)n_kv * passes > 65535 || t_alloc > MAX_T || live < 1 || live > t_alloc ||
      !plan_ok(hd, bits, blocks, rows, stages)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(blocks, n_kv * passes, b);
  const long long scale_count = (long long)b * n_kv * t_alloc;
  const cudaStream_t s = (cudaStream_t)stream;
#define WMT_GQA(H, B)                                                                           \
  launch<H, B>(grid, blocks, stages, s, q, k, ks, v, vs, pos, out, n_kv, rep, tq, t_alloc, \
                  live, scale, out_bf16, scale_count, passes)
  cudaError_t e;
  if (hd == 128) {
    e = bits == 8 ? WMT_GQA(128, 8) : WMT_GQA(128, 4);
  } else {
    e = bits == 8 ? WMT_GQA(64, 8) : WMT_GQA(64, 4);
  }
#undef WMT_GQA
  if (e == cudaSuccess) e = cudaGetLastError();
  return (int)e;
}

// cudaOccupancyMaxActiveClusters for clusters of `blocks` at `stages`: >= 0,
// or minus the CUDA error.
extern "C" int wmt_gqa_cluster_room(int hd, int bits, int blocks, int stages) {
  if (!plan_ok(hd, bits, blocks, ROWS, stages)) return -(int)cudaErrorInvalidValue;
  int room = 0;
  cudaError_t e;
  if (hd == 128) {
    e = bits == 8 ? cluster_room<128, 8>(blocks, stages, &room)
                  : cluster_room<128, 4>(blocks, stages, &room);
  } else {
    e = bits == 8 ? cluster_room<64, 8>(blocks, stages, &room)
                  : cluster_room<64, 4>(blocks, stages, &room);
  }
  return e == cudaSuccess ? room : -(int)e;
}
