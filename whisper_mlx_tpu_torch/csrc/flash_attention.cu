// Online-softmax (flash) attention for Hopper (sm_90a), causal or not,
// with grouped KV heads.
//
// Replaces: whisper_mlx_tpu/ops/flash_attention.py:flash_attention
// (_flash_kernel), the Pallas TPU kernel of the Qwen prefill (causal) and of
// whisper encoder attention over more than 2048 keys (non-causal).
//
// Computes, per (batch, head) and query row, with q and k pre-scaled by
// hd^-1/4 and KV head = head / (H / KV):
//     s = q . k^T (keys >= Tk, and keys after the row when causal, masked)
//     out = softmax(s) . v, by the online-softmax recurrence in fp32
// The TPU kernel multiplies p . v in fp32; this one rounds p to bf16 for the
// tensor cores (the tolerance against the fp32 plain version says so).
//
// What bounds it on the H100: tensor-core operations. A causal prefill at
// H = 64, KV = 8, hd = 128, T = 2048 is 69 GFLOP over 76 MB of q, k, v and out.
//
// Design (attn_tile.cuh): a block of two consumer warpgroups (64 query rows
// each, 128 a block) and one producer warpgroup. The producer streams 128-key K
// and V tiles by TMA into a ring of 3 (hd 128) or 4 stages; the consumers
// compute S = Q . K^T by wgmma from shared memory into registers, run the
// online softmax there (exp2 with log2(e) folded into one FMA, row max and
// sum over the four lanes of a row by two shuffles), rescale the fp32 output
// accumulator, which stays in registers, and add P . V by wgmma with P as
// the register operand and V read MN-major from the ring. Causal: key tiles
// past the block's last row are never loaded, only tiles that cross the
// diagonal or the end of the keys are masked, and the grid's slow index runs
// the q-tiles backwards so the heaviest blocks start first. GQA: the H / KV
// query heads of one KV head are adjacent blocks (the fast grid index), so
// their K and V tiles come from L2.
#include "attn_tile.cuh"

namespace {

using namespace attn;

template <int HDP, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
flash_attn_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
                  int h, int kvh, int tq, int tk, int hd, int causal) {
  using R = Ring<HDP, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  R& ring = R::at(smem_raw);
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest q-tile first
  const int key_end = causal ? min(tk, q0 + BQ) : tk;
  const int ntiles = (key_end + BK - 1) / BK;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      const int kv_row = (bh / h) * kvh + (bh % h) / (h / kvh);
      ring.load_q(&qmap, q0, bh);
      for (int n = 0; n < ntiles; ++n) ring.load_kv(n, &kmap, &vmap, n * BK, kv_row);
    }
  } else {
    regs_inc<CONSUMER_REGS>();
    const Place me(q0);
    float o[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
    float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
    mbar_wait(&ring.qbar, 0);
    for (int n = 0; n < ntiles; ++n) {
      const int stage = ring.wait_full(n);
      const int key0 = n * BK;
      float s[BK / 2];
      qk_tile<HDP>(s, ring.q[me.wg], ring.k[stage]);
      if (key0 + BK > tk || (causal && key0 + BK - 1 > me.row_base)) {
        mask_tile(s, key0, tk, causal, me.row0, me.row1, me.lane);
      }
      float t0, t1;
      tile_max(s, t0, t1);
      const float n0 = fmaxf(m0, t0), n1 = fmaxf(m1, t1);
      const float a0 = exp2f((m0 - n0) * LOG2E), a1 = exp2f((m1 - n1) * LOG2E);
      const float b0 = n0 * LOG2E, b1 = n1 * LOG2E;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        if (i & 2) {
          s[i] = exp2f(fmaf(s[i], LOG2E, -b1));
          sum1 += s[i];
        } else {
          s[i] = exp2f(fmaf(s[i], LOG2E, -b0));
          sum0 += s[i];
        }
      }
      l0 = l0 * a0 + quad_sum(sum0);
      l1 = l1 * a1 + quad_sum(sum1);
      m0 = n0;
      m1 = n1;
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) o[i] *= (i & 2) ? a1 : a0;
      uint32_t p[BK / 16][4];
      pack_p(s, p);
      pv_tile<HDP>(o, p, ring.v[stage]);
      ring.release(stage);
    }
    store_out<HDP>(o, 1.f / l0, 1.f / l1, ring.q[me.wg], out + (size_t)bh * tq * hd,
                   me.row_base, tq, hd, me.wg);
  }
}

template <int HDP, int STAGES>
int launch(const void* q, const void* k, const void* v, void* out, int b, int h, int kvh,
           int tq, int tk, int hd, int causal, cudaStream_t stream) {
  using R = Ring<HDP, STAGES>;
  auto kernel = flash_attn_kernel<HDP, STAGES>;
  const cudaError_t err = wmt_async::allow_smem<flash_attn_kernel<HDP, STAGES>>(smem_bytes<R>());
  if (err != cudaSuccess) return (int)err;
  CUtensorMap qm, km, vm;
  if (!tensor_map(&qm, q, b * h, tq, hd, 64) || !tensor_map(&km, k, b * kvh, tk, hd, BK) ||
      !tensor_map(&vm, v, b * kvh, tk, hd, BK)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(b * h, (tq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem_bytes<R>(), stream>>>(qm, km, vm, (__nv_bfloat16*)out, h, kvh,
                                                     tq, tk, hd, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wmt_flash_attention(const void* q, const void* k, const void* v,
                                   void* out, int b, int h, int kvh, int tq, int tk,
                                   int hd, int causal, void* stream) {
  if (b < 1 || h < 1 || kvh < 1 || h % kvh || tq < 1 || tk < 1 ||
      (tq + BQ - 1) / BQ > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 16:
    case 32:
    case 64: return launch<64, 4>(q, k, v, out, b, h, kvh, tq, tk, hd, causal, s);
    case 128: return launch<128, 3>(q, k, v, out, b, h, kvh, tq, tk, hd, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
