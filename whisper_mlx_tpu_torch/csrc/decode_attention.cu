// Decode attention over a quantized KV cache for Hopper (sm_90a).
//
// Replaces: whisper_mlx_tpu/ops/decode_attention.py:decode_attention_int8
// (_decode_dma_kernel for Tq=1, _decode_attn_kernel for Tq>1), the same
// function as ops/kv_quant.py:attention_int8_auto and, with a group g > 1,
// attention_int8_grouped. With int_dot it computes the integer-dot function
// of ops/kv_quant.py:attention_int8_mxu / attention_int8_grouped_mxu (XLA on
// the TPU, the beam default): q and w * vs re-quantized per row to int8 and
// both dots s8 x s8 -> s32 (attend_row.cuh).
//
// Cache layout (Hopper-native, position-major within a head):
//   codes  (B, H, T_alloc, 64) int8, or (B, H, T_alloc, 32) uint8 holding two
//          signed int4 nibbles per byte (low nibble = even d, high = odd d)
//   scales (B, H, T_alloc) bf16
// Query row b reads KV row b / group. Per query row i:
//   s_t = (q . k_t) * ks_t            fp32 accumulate
//   keys t <= pos + i (causal) and t < valid_len are attended
//   w = softmax(s) in fp32; w_t * vs_t rounded to bf16
//   out = sum_t (w_t vs_t) v_t        fp32 accumulate -> bf16
//
// What bounds it on the H100: device-memory bytes. A decode step reads every
// cached code once: the int4 cross cache holds K and V codes of 32 B each
// plus a 2 B scale each, 68 B per (row, head, position), 1500 positions x
// 20 heads x 32 layers per row, and the dot products are 2 operations per
// code, far below the card's operations-per-byte balance in either mode.
//
// Simple design: one block of 128 threads per (query row, head) running
// attend_row.cuh: four threads share one key row, scores go to shared
// memory, block reductions give the max, the sum and (integer mode) the
// absmax of w * vs, and the weighted sum of V is reduced across the 32 key
// lanes in shared memory. The key loop stops at min(pos + i + 1, valid_len):
// dead cache positions are never read. Split-K over the 1500 cross positions
// is later work.
#include "attend_row.cuh"

namespace {

using namespace wmt_attn;

template <int BITS, bool INT_DOT>
__global__ void __launch_bounds__(THREADS)
decode_attn_kernel(const __nv_bfloat16* __restrict__ q,
                   const uint8_t* __restrict__ k,
                   const __nv_bfloat16* __restrict__ ks,
                   const uint8_t* __restrict__ v,
                   const __nv_bfloat16* __restrict__ vs,
                   __nv_bfloat16* __restrict__ out,
                   int n_head, int tq, int t_alloc, int group, int pos,
                   int causal, int valid_len) {
  constexpr int ROWB = BITS * HD / 8;
  __shared__ Smem sm;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t head = ((size_t)(b / group) * n_head + h) * t_alloc;
  for (int i = 0; i < tq; ++i) {
    const size_t qoff = (((size_t)b * n_head + h) * tq + i) * HD;
    const int limit = causal ? min(pos + i + 1, valid_len) : valid_len;
    attend_row<BITS, INT_DOT, !INT_DOT>(q + qoff, k + head * ROWB, ks + head,
                                        v + head * ROWB, vs + head, limit,
                                        InOrder{}, out + qoff, sm);
  }
}

template <int BITS, bool INT_DOT>
void launch(dim3 grid, cudaStream_t s, const void* q, const void* k, const void* ks,
            const void* v, const void* vs, void* out, int n_head, int tq, int t_alloc,
            int group, int pos, int causal, int valid_len) {
  decode_attn_kernel<BITS, INT_DOT><<<grid, THREADS, 0, s>>>(
      (const __nv_bfloat16*)q, (const uint8_t*)k, (const __nv_bfloat16*)ks,
      (const uint8_t*)v, (const __nv_bfloat16*)vs, (__nv_bfloat16*)out,
      n_head, tq, t_alloc, group, pos, causal, valid_len);
}

}  // namespace

extern "C" int wmt_decode_attention(const void* q, const void* k,
                                    const void* ks, const void* v,
                                    const void* vs, void* out, int bq,
                                    int n_head, int tq, int t_alloc, int group,
                                    int pos, int causal, int valid_len,
                                    int bits, int int_dot, void* stream) {
  if (t_alloc > MAX_T || valid_len < 1 || valid_len > t_alloc || group < 1 ||
      bq < 1 || bq > 65535 || n_head < 1 || tq < 1 || pos < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(n_head, bq);
  cudaStream_t s = (cudaStream_t)stream;
  if (bits == 8 && !int_dot) {
    launch<8, false>(grid, s, q, k, ks, v, vs, out, n_head, tq, t_alloc, group, pos,
                     causal, valid_len);
  } else if (bits == 4 && !int_dot) {
    launch<4, false>(grid, s, q, k, ks, v, vs, out, n_head, tq, t_alloc, group, pos,
                     causal, valid_len);
  } else if (bits == 8) {
    launch<8, true>(grid, s, q, k, ks, v, vs, out, n_head, tq, t_alloc, group, pos,
                    causal, valid_len);
  } else if (bits == 4) {
    launch<4, true>(grid, s, q, k, ks, v, vs, out, n_head, tq, t_alloc, group, pos,
                    causal, valid_len);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
