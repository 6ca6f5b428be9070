// Non-causal encoder self-attention for Hopper (sm_90a).
//
// Replaces: whisper_mlx_tpu/ops/dense_attention.py:dense_attention
// (_dense_attn_kernel), the Pallas TPU kernel the encoder uses when
// flash_attention=True and Tk <= 2048.
//
// Computes, per (batch*head) row, with q and k pre-scaled by hd^-1/4:
//     s = q . k^T   (bf16 in, fp32 accumulate; keys >= Tk masked)
//     w = softmax(s) in fp32, rounded to bf16
//     out = w . v   (bf16 in, fp32 accumulate) -> bf16
// and, in the TPU kernel's bf16-softmax mode (fast_softmax,
// WTPU_DENSE_SOFTMAX=bf16), its rounding points instead: the scores rounded
// to bf16, the row max taken over those, p = bf16(exp(bf16(s - max))), the
// denominator the fp32 sum of those bf16 p, w = bf16(p * bf16(1 / denom)).
//
// What bounds it on the H100: tensor-core operations. At the encoder shape
// (B*20 heads, T = 1500, hd = 64) one call is 4*B*20*1500^2*64 FLOPs over
// 4*B*20*1500*64*2 bytes.
//
// Design (attn_tile.cuh, shared with K4): a block of two consumer warpgroups
// (64 query rows each) and one producer warpgroup that streams 128-key tiles by
// TMA into a 4-stage ring. S = Q . K^T runs on wgmma into registers, the
// softmax runs there, and P . V runs on wgmma with the bf16 weights as the
// register operand and V read MN-major from the ring; the output
// accumulator stays in registers. The reference rounds the *normalized*
// weights to bf16, which needs each row's final max and denominator before
// the first weight, so the keys are walked twice: pass 1 (K only) computes
// each row's max and denominator by the online recurrence, pass 2 (K and V)
// recomputes S and forms w = bf16(exp(s - max) / denom). The bf16-softmax
// mode needs the exact bf16 max before any rounded exponential, so it walks
// a pass 0 (K only, max of bf16(s)) in front, and pass 1 sums the rounded p.
// The q-tile is the fast grid index, so the blocks of one (b, h) run
// together and share K and V in L2.
#include "attn_tile.cuh"

namespace {

using namespace attn;

constexpr int HDP = 64;
constexpr int STAGES = 4;
using R = Ring<HDP, STAGES>;

// p of the bf16-softmax mode for two scores of one row: bf16(exp(bf16(bf16(s)
// - m))), m a bf16 value, each rounding one conversion for the pair. The
// exponential is exp2f of one product: the mode's rounding points, with an
// fp32 exponential that may differ from expf in its last bits.
__device__ __forceinline__ float2 fast_p2(float s0, float s1, float m) {
  float2 r = round2_bf16(s0, s1);
  r = round2_bf16(r.x - m, r.y - m);
  return round2_bf16(exp2f(r.x * LOG2E), exp2f(r.y * LOG2E));
}

template <bool FAST>
__global__ void __launch_bounds__(THREADS, 1)
dense_attn_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
                  int tq, int tk) {
  constexpr int PASSES = FAST ? 3 : 2;
  extern __shared__ unsigned char smem_raw[];
  R& ring = R::at(smem_raw);
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int ntiles = (tk + BK - 1) / BK;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      ring.load_q(&qmap, q0, bh);
      for (int pass = 0, n = 0; pass < PASSES; ++pass) {
        const CUtensorMap* v = pass == PASSES - 1 ? &vmap : nullptr;
        for (int t = 0; t < ntiles; ++t, ++n) ring.load_kv(n, &kmap, v, t * BK, bh);
      }
    }
  } else {
    regs_inc<CONSUMER_REGS>();
    const Place me(q0);
    const bool ragged = tk % BK != 0;
    float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
    float s[BK / 2];
    int n = 0;
    mbar_wait(&ring.qbar, 0);

    // bf16-softmax mode, pass 0: the row max of the bf16-rounded scores,
    // which is the rounded max of the scores (rounding is monotone)
    if constexpr (FAST) {
      for (int t = 0; t < ntiles; ++t, ++n) {
        const int stage = ring.wait_full(n);
        qk_tile<HDP>(s, ring.q[me.wg], ring.k[stage]);
        ring.release(stage);
        if (ragged && t == ntiles - 1) mask_tile(s, t * BK, tk, false, 0, 0, me.lane);
        float t0, t1;
        tile_max(s, t0, t1);
        m0 = fmaxf(m0, t0);
        m1 = fmaxf(m1, t1);
      }
      m0 = round_bf16(m0);
      m1 = round_bf16(m1);
    }

    // pass 1: the denominator (and, in the exact mode, the max, online)
    for (int t = 0; t < ntiles; ++t, ++n) {
      const int stage = ring.wait_full(n);
      qk_tile<HDP>(s, ring.q[me.wg], ring.k[stage]);
      ring.release(stage);
      if (ragged && t == ntiles - 1) mask_tile(s, t * BK, tk, false, 0, 0, me.lane);
      float sum0 = 0.f, sum1 = 0.f;
      if constexpr (FAST) {
#pragma unroll
        for (int i = 0; i < BK / 2; i += 2) {
          const float2 p = fast_p2(s[i], s[i + 1], (i & 2) ? m1 : m0);
          if (i & 2) sum1 += p.x + p.y; else sum0 += p.x + p.y;
        }
        l0 += quad_sum(sum0);
        l1 += quad_sum(sum1);
      } else {
        float t0, t1;
        tile_max(s, t0, t1);
        const float n0 = fmaxf(m0, t0), n1 = fmaxf(m1, t1);
        const float b0 = n0 * LOG2E, b1 = n1 * LOG2E;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          if (i & 2) sum1 += exp2f(fmaf(s[i], LOG2E, -b1));
          else sum0 += exp2f(fmaf(s[i], LOG2E, -b0));
        }
        l0 = l0 * exp2f((m0 - n0) * LOG2E) + quad_sum(sum0);
        l1 = l1 * exp2f((m1 - n1) * LOG2E) + quad_sum(sum1);
        m0 = n0;
        m1 = n1;
      }
    }
    // the factor each weight takes: bf16(1 / denom) in the bf16-softmax mode
    const float inv0 = FAST ? round_bf16(1.f / l0) : 1.f / l0;
    const float inv1 = FAST ? round_bf16(1.f / l1) : 1.f / l1;
    const float b0 = m0 * LOG2E, b1 = m1 * LOG2E;

    // pass 2: the normalized weights, rounded to bf16 as P, times V
    float o[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
    for (int t = 0; t < ntiles; ++t, ++n) {
      const int stage = ring.wait_full(n);
      qk_tile<HDP>(s, ring.q[me.wg], ring.k[stage]);
      if (ragged && t == ntiles - 1) mask_tile(s, t * BK, tk, false, 0, 0, me.lane);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        if constexpr (FAST) {
          if (i & 1) continue;
          const float2 p = fast_p2(s[i], s[i + 1], (i & 2) ? m1 : m0);
          const float inv = (i & 2) ? inv1 : inv0;
          s[i] = p.x * inv;
          s[i + 1] = p.y * inv;
        } else {
          s[i] = (i & 2) ? exp2f(fmaf(s[i], LOG2E, -b1)) * inv1
                         : exp2f(fmaf(s[i], LOG2E, -b0)) * inv0;
        }
      }
      uint32_t p[BK / 16][4];
      pack_p(s, p);
      pv_tile<HDP>(o, p, ring.v[stage]);
      ring.release(stage);
    }
    store_out<HDP>(o, 1.f, 1.f, ring.q[me.wg], out + (size_t)bh * tq * HDP, me.row_base, tq,
                   HDP, me.wg);
  }
}

template <bool FAST>
int launch(const void* q, const void* k, const void* v, void* out, int bh, int tq, int tk,
           cudaStream_t stream) {
  auto kernel = dense_attn_kernel<FAST>;
  const cudaError_t err = wmt_async::allow_smem<dense_attn_kernel<FAST>>(smem_bytes<R>());
  if (err != cudaSuccess) return (int)err;
  CUtensorMap qm, km, vm;
  if (!tensor_map(&qm, q, bh, tq, HDP, 64) || !tensor_map(&km, k, bh, tk, HDP, BK) ||
      !tensor_map(&vm, v, bh, tk, HDP, BK)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((tq + BQ - 1) / BQ, bh);
  kernel<<<grid, THREADS, smem_bytes<R>(), stream>>>(qm, km, vm, (__nv_bfloat16*)out, tq, tk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wmt_dense_attention(const void* q, const void* k, const void* v,
                                   void* out, int bh, int tq, int tk,
                                   int fast_softmax, void* stream) {
  if (bh < 1 || tq < 1 || tk < 1 || bh > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return fast_softmax ? launch<true>(q, k, v, out, bh, tq, tk, s)
                      : launch<false>(q, k, v, out, bh, tq, tk, s);
}
