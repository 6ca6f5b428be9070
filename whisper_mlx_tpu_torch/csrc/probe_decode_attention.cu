// The decode-attention probe kernels for Hopper (sm_90a).
//
// Replaces: scripts/bench_decode_attention.py:batched_attention
// (_batched_kernel) and scripts/bench_da_ablation.py:run (make(stage)), the
// Pallas TPU kernels that probe kernel K3's design: the first computes
// one-query attention over an int8 cache whose keys are time-minor, for
// `bh_tile` (row, head) pairs a program; the second runs that work in five
// cumulative stages to show where its time goes.
//
// batched attention, per (row, head) pair and query row i:
//   s_t = (q . K[:, t]) * ks_t          K (64, Tk) int8, fp32 accumulate
//   keys t < valid_len and, causal, t <= pos + i are attended
//   w = softmax(s) in fp32; w_t * vs_t rounded to bf16
//   out = sum_t (w_t vs_t) V[t, :]      V (Tk, 64) int8, fp32 accumulate -> bf16
//
// ablation stages over K and V both (64, Tk) int8, no scales, one query:
//   dmak  out = q + K[0, 0]                        after moving all of K
//   dma   out = q + K[0, 0] + V[0, 0]              after moving K and V
//   cast  out = q + max_t K[d, t] + max_t V[d, t]  (bf16 additions)
//   dots  s = q . K;  w = bf16(s * 1e-4);  out = w . V^T
//   full  s = q . K;  w = bf16(softmax(s)); out = w . V^T
//
// What bounds them on the H100: the bytes of the cache (128 B of codes and,
// with scales, 8 B more per position), read once; the dots are 2 operations
// per code. Design: a block takes `bh_tile` (row, head) pairs. With K
// time-minor a lane takes four neighbouring positions of one hd row per load
// and a warp 128 of them: every load is a full line, and a lane's scores
// never leave it until the softmax, the opposite of K3's position-major rows
// whose four threads share a key. One warp a pair leaves a pair's 1500 keys
// to 64 dependent loads a chunk and the card mostly idle (its first form:
// 0.40 ms at the cross shape whatever the tile), so the batched kernel shares
// the block's warps among its pairs: four warps a pair up to 8 pairs, two up
// to 16, one above, split over the key positions and joined by one hardware
// barrier a pair. It stops at the live length, as K3 does. The ablation
// kernel keeps one warp a pair and moves every row of its block through a
// two-slot shared-memory ring with 16-byte cp.async copies in every stage,
// dmak and dma too (an asynchronous copy is issued whatever becomes of the
// data, so those stages do measure the stream), and each later stage adds its
// work on the rows as they land.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// softmax weights of s[0 .. limit) in place, times scale[t] when given,
// rounded to bf16; one warp
__device__ __forceinline__ void warp_softmax(float* s, const float* scale, int limit, int lane) {
  float m = NEG;
  for (int t = lane; t < limit; t += 32) m = fmaxf(m, s[t]);
  m = warp_max(m);
  float sum = 0.f;
  for (int t = lane; t < limit; t += 32) {
    const float p = expf(s[t] - m);
    s[t] = p;
    sum += p;
  }
  sum = warp_sum(sum);
  for (int t = lane; t < limit; t += 32) {
    const float w = s[t] / sum;
    s[t] = round_bf16(scale ? w * __ldg(scale + t) : w);
  }
  __syncwarp();
}

// barrier among the `threads` threads of one (row, head) pair's warps; one
// hardware barrier a pair (ids 0 .. 15), never __syncthreads in that kernel
__device__ __forceinline__ void pair_sync(int id, int threads) {
  if (threads == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
  }
}

constexpr int MAX_WPP = 4;  // warps that share one pair

// One block takes bh_tile pairs and shares up to 32 warps among them: wpp
// warps a pair (4 up to 8 pairs, 2 up to 16, else 1), which split the key
// positions in chunks of 128 (scores) and in interleaved row pairs (values).
__host__ __device__ constexpr int pair_floats(int tk, int wpp) {
  // Tk scores, the query, the warps' partial max and sum, their outputs
  return tk + HD + 2 * MAX_WPP + wpp * HD;
}

__global__ void __launch_bounds__(1024)
batched_attn_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ kt,
                    const float* __restrict__ ks, const int8_t* __restrict__ v,
                    const float* __restrict__ vs, __nv_bfloat16* __restrict__ out,
                    int bh, int tq, int tk, int valid_len, int causal, int pos, int wpp) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slot = warp / wpp;  // this block's pair
  const int sub = warp % wpp;   // this warp among the pair's
  const int pair = blockIdx.x * ((blockDim.x >> 5) / wpp) + slot;
  if (pair >= bh) return;  // all of a pair's warps leave together
  float* s = smem + (size_t)slot * pair_floats(tk, wpp);
  float* qs = s + tk;
  float* red = qs + HD;
  float* opart = red + 2 * MAX_WPP;
  const int8_t* kp = kt + (size_t)pair * HD * tk;
  const int8_t* vp = v + (size_t)pair * tk * HD;
  const float* ksp = ks + (size_t)pair * tk;
  const float* vsp = vs + (size_t)pair * tk;
  const int threads = wpp * 32;

  for (int i = 0; i < tq; ++i) {
    const size_t qoff = ((size_t)pair * tq + i) * HD;
    const int limit = causal ? min(pos + i + 1, valid_len) : valid_len;
    if (sub == 0) {
      qs[lane] = __bfloat162float(q[qoff + lane]);
      qs[lane + 32] = __bfloat162float(q[qoff + lane + 32]);
    }
    pair_sync(slot, threads);
    float m = NEG;
    for (int t0 = 128 * sub + 4 * lane; t0 < limit; t0 += 128 * wpp) {
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        const char4 c = __ldg(reinterpret_cast<const char4*>(kp + (size_t)d * tk + t0));
        const float qd = qs[d];
        a0 = fmaf(qd, (float)c.x, a0);
        a1 = fmaf(qd, (float)c.y, a1);
        a2 = fmaf(qd, (float)c.z, a2);
        a3 = fmaf(qd, (float)c.w, a3);
      }
      const float4 sc = __ldg(reinterpret_cast<const float4*>(ksp + t0));
      const float sv[4] = {a0 * sc.x, a1 * sc.y, a2 * sc.z, a3 * sc.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[t0 + e] = sv[e];
        if (t0 + e < limit) m = fmaxf(m, sv[e]);
      }
    }
    m = warp_max(m);
    if (lane == 0) red[sub] = m;
    pair_sync(slot, threads);
    for (int w = 0; w < wpp; ++w) m = fmaxf(m, red[w]);
    // each warp turns its own chunks into exponentials and sums them
    float sum = 0.f;
    for (int t0 = 128 * sub; t0 < limit; t0 += 128 * wpp) {
      for (int t = t0 + lane; t < min(t0 + 128, limit); t += 32) {
        const float p = expf(s[t] - m);
        s[t] = p;
        sum += p;
      }
    }
    sum = warp_sum(sum);
    if (lane == 0) red[MAX_WPP + sub] = sum;
    pair_sync(slot, threads);
    sum = 0.f;
    for (int w = 0; w < wpp; ++w) sum += red[MAX_WPP + w];
    for (int t0 = 128 * sub; t0 < limit; t0 += 128 * wpp) {
      for (int t = t0 + lane; t < min(t0 + 128, limit); t += 32) {
        s[t] = round_bf16(s[t] / sum * __ldg(vsp + t));
      }
    }
    pair_sync(slot, threads);
    // lanes 0-15 take even positions, 16-31 odd ones: a warp reads two
    // whole 64-byte V rows per load; the pair's warps interleave row pairs
    const int d4 = (lane & 15) * 4;
    float o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
    for (int t = 2 * sub + (lane >> 4); t < limit; t += 2 * wpp) {
      const char4 c = __ldg(reinterpret_cast<const char4*>(vp + (size_t)t * HD + d4));
      const float w = s[t];
      o0 = fmaf(w, (float)c.x, o0);
      o1 = fmaf(w, (float)c.y, o1);
      o2 = fmaf(w, (float)c.z, o2);
      o3 = fmaf(w, (float)c.w, o3);
    }
    o0 += __shfl_xor_sync(FULL, o0, 16);
    o1 += __shfl_xor_sync(FULL, o1, 16);
    o2 += __shfl_xor_sync(FULL, o2, 16);
    o3 += __shfl_xor_sync(FULL, o3, 16);
    if (lane < 16) {
      float* op = opart + sub * HD + d4;
      op[0] = o0;
      op[1] = o1;
      op[2] = o2;
      op[3] = o3;
    }
    pair_sync(slot, threads);
    if (sub == 0) {
      for (int d = lane; d < HD; d += 32) {
        float o = 0.f;
        for (int w = 0; w < wpp; ++w) o += opart[w * HD + d];
        out[qoff + d] = __float2bfloat16_rn(o);
      }
    }
    pair_sync(slot, threads);
  }
}

// ---------------------------------------------------------------------------
// the ablation stages
// ---------------------------------------------------------------------------

enum Stage { DMAK = 0, DMA = 1, CAST = 2, DOTS = 3, FULL_ATTN = 4 };

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// bytes of shared memory one warp takes: the two ring slots, 128 per-row
// results, and from the dots stage on the Tk scores
__host__ __device__ constexpr int ablation_warp_bytes(int stage, int tk) {
  return 2 * tk + 128 * 4 + (stage >= DOTS ? tk * 4 : 0);
}

template <int STAGE>
__global__ void __launch_bounds__(1024)
ablation_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ kt,
                const int8_t* __restrict__ vt, __nv_bfloat16* __restrict__ out, int bh, int tk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * (blockDim.x >> 5) + warp;
  if (pair >= bh) return;
  unsigned char* mine = smem_raw + (size_t)warp * ablation_warp_bytes(STAGE, tk);
  int8_t* ring = reinterpret_cast<int8_t*>(mine);             // 2 x tk bytes
  float* res = reinterpret_cast<float*>(mine + 2 * tk);       // per-row results
  float* s = res + 128;                                       // scores (dots, full)
  const int n_rows = STAGE == DMAK ? HD : 2 * HD;             // K rows, then V rows
  const __nv_bfloat16* qp = q + (size_t)pair * HD;

  auto issue = [&](int r) {
    const int8_t* src = (r < HD ? kt : vt) + ((size_t)pair * HD + (r & (HD - 1))) * tk;
    int8_t* dst = ring + (r & 1) * tk;
    for (int off = lane * 16; off < tk; off += 512) cp_async16(dst + off, src + off);
    cp_async_commit();
  };

  issue(0);
  for (int r = 0; r < n_rows; ++r) {
    if (r + 1 < n_rows) {
      issue(r + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const int8_t* row = ring + (r & 1) * tk;
    if constexpr (STAGE == DMAK || STAGE == DMA) {
      if ((r & (HD - 1)) == 0 && lane == 0) res[r] = (float)row[0];
    } else if constexpr (STAGE == CAST) {
      int mx = -128;
      for (int t0 = lane * 4; t0 < tk; t0 += 128) {
        const char4 c = *reinterpret_cast<const char4*>(row + t0);
        mx = max(max(mx, max((int)c.x, (int)c.y)), max((int)c.z, (int)c.w));
      }
      const float m = warp_max((float)mx);
      if (lane == 0) res[r] = m;
    } else if (r < HD) {  // dots, full: this K row's share of every score
      const float qd = __bfloat162float(qp[r]);
      for (int t0 = lane * 4; t0 < tk; t0 += 128) {
        const char4 c = *reinterpret_cast<const char4*>(row + t0);
        float4 a = r == 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : *reinterpret_cast<float4*>(s + t0);
        a.x = fmaf(qd, (float)c.x, a.x);
        a.y = fmaf(qd, (float)c.y, a.y);
        a.z = fmaf(qd, (float)c.z, a.z);
        a.w = fmaf(qd, (float)c.w, a.w);
        *reinterpret_cast<float4*>(s + t0) = a;
      }
      if (r == HD - 1) {
        __syncwarp();
        if constexpr (STAGE == DOTS) {
          for (int t = lane; t < tk; t += 32) s[t] = round_bf16(s[t] * 1e-4f);
        } else {
          warp_softmax(s, nullptr, tk, lane);
        }
      }
    } else {  // dots, full: out[d] = w . V[d, :]
      float acc = 0.f;
      for (int t0 = lane * 4; t0 < tk; t0 += 128) {
        const char4 c = *reinterpret_cast<const char4*>(row + t0);
        const float4 w = *reinterpret_cast<const float4*>(s + t0);
        acc = fmaf(w.x, (float)c.x, acc);
        acc = fmaf(w.y, (float)c.y, acc);
        acc = fmaf(w.z, (float)c.z, acc);
        acc = fmaf(w.w, (float)c.w, acc);
      }
      acc = warp_sum(acc);
      if (lane == 0) res[r - HD] = acc;
    }
    __syncwarp();
  }

  for (int d = lane; d < HD; d += 32) {
    const float qd = __bfloat162float(qp[d]);
    float o;
    if constexpr (STAGE == DMAK) {
      o = qd + res[0];
    } else if constexpr (STAGE == DMA) {
      o = round_bf16(qd + res[0]) + res[HD];
    } else if constexpr (STAGE == CAST) {
      o = round_bf16(qd + res[d]) + res[HD + d];
    } else {
      o = res[d];
    }
    out[(size_t)pair * HD + d] = __float2bfloat16_rn(o);
  }
}

template <int STAGE>
int launch_ablation(const void* q, const void* kt, const void* vt, void* out, int bh, int tk,
                    int bh_tile, cudaStream_t stream) {
  const int smem = bh_tile * ablation_warp_bytes(STAGE, tk);
  cudaError_t err = cudaFuncSetAttribute(ablation_kernel<STAGE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ablation_kernel<STAGE><<<(bh + bh_tile - 1) / bh_tile, bh_tile * 32, smem, stream>>>(
      (const __nv_bfloat16*)q, (const int8_t*)kt, (const int8_t*)vt, (__nv_bfloat16*)out, bh, tk);
  return (int)cudaGetLastError();
}

}  // namespace

// q (BH, Tq, 64) bf16, kt (BH, 64, Tk) int8, ks and vs (BH, Tk) fp32,
// v (BH, Tk, 64) int8, out (BH, Tq, 64) bf16; bh_tile warps a block
extern "C" int wmt_probe_batched_attention(const void* q, const void* kt, const void* ks,
                                           const void* v, const void* vs, void* out, int bh,
                                           int tq, int tk, int valid_len, int causal, int pos,
                                           int bh_tile, void* stream) {
  if (bh < 1 || tq < 1 || tk < 4 || tk % 4 || valid_len < 1 || valid_len > tk || pos < 0 ||
      bh_tile < 1 || bh_tile > 32) {
    return (int)cudaErrorInvalidValue;
  }
  const int wpp = bh_tile > 16 ? 1 : (bh_tile > 8 ? 2 : MAX_WPP);  // at most 16 barriers
  const int smem = bh_tile * pair_floats(tk, wpp) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(batched_attn_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  batched_attn_kernel<<<(bh + bh_tile - 1) / bh_tile, bh_tile * wpp * 32, smem,
                        (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const int8_t*)kt, (const float*)ks, (const int8_t*)v,
      (const float*)vs, (__nv_bfloat16*)out, bh, tq, tk, valid_len, causal, pos, wpp);
  return (int)cudaGetLastError();
}

// q (BH, 1, 64) bf16, kt and vt (BH, 64, Tk) int8, out (BH, 1, 64) bf16;
// stage: 0 dmak, 1 dma, 2 cast, 3 dots, 4 full
extern "C" int wmt_probe_ablation(const void* q, const void* kt, const void* vt, void* out,
                                  int bh, int tk, int stage, int bh_tile, void* stream) {
  if (bh < 1 || tk < 16 || tk % 16 || bh_tile < 1 || bh_tile > 32) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  switch (stage) {
    case DMAK: return launch_ablation<DMAK>(q, kt, vt, out, bh, tk, bh_tile, s);
    case DMA: return launch_ablation<DMA>(q, kt, vt, out, bh, tk, bh_tile, s);
    case CAST: return launch_ablation<CAST>(q, kt, vt, out, bh, tk, bh_tile, s);
    case DOTS: return launch_ablation<DOTS>(q, kt, vt, out, bh, tk, bh_tile, s);
    case FULL_ATTN: return launch_ablation<FULL_ATTN>(q, kt, vt, out, bh, tk, bh_tile, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
