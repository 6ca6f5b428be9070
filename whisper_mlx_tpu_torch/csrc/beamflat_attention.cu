// Beam self-attention over the lane-interleaved flat cache for Hopper (sm_90a).
//
// Replaces: whisper_mlx_tpu/ops/beamflat_attention.py:beamflat_attention_kernel
// (_kernel), the fused form of ops/kv_quant.py:attention_int8_beamflat; with
// int_dot it computes that function's integer-dot branch (mxu=True, the beam
// default over quantized caches).
//
// Layout (position-major, like the port's other caches): a window's g beam
// lanes share one cache whose row t * g + k holds lane k's position t:
//   codes  (n, H, T * g, 64) int8, or (n, H, T * g, 32) packed int4
//   scales (n, H, T * g) bf16
//   ancestry (n * g, T_anc) int32 in [0, g): lane owning position t of lane
//            b's hypothesis
// Query row b (window b / g) attends positions t <= pos. The TPU kernel takes
// a precomputed (n, g, T * g) ancestry-and-causal mask and scans every column;
// exactly one column per (lane, position) is unmasked, t * g + ancestry[b, t].
// So each block gathers its pos + 1 rows instead: softmax over the masked
// columns equals softmax over the gathered rows, and in the integer mode the
// absmax of w * vs is unchanged (the masked entries are 0).
//
// What bounds it on the H100: device-memory bytes. Every step reads a layer's
// live cache once, 64 + 64 B of int8 codes and 2 + 2 B of scales per (row,
// head, live position): large-v3, beam 5, 8 windows, pos 226 is about 24 MB
// per layer, about 7 us at 3.35 TB/s. The dots are 2 operations per code.
//
// Simple design: one block of 128 threads per (lane, head), the row loop of
// attend_row.cuh with the ancestry gather as its row map. Lanes of a window
// gather mostly the same rows (their shared prefix), which L2 serves after
// the first lane, so device memory sees the live cache about once.
#include "attend_row.cuh"

namespace {

using namespace wmt_attn;

// Cache row of position t for one lane: t * g + ancestry[t].
struct AncestryRow {
  const int* anc;
  int g;
  __device__ __forceinline__ int operator()(int t) const { return t * g + anc[t]; }
};

template <int BITS, bool INT_DOT>
__global__ void __launch_bounds__(THREADS)
beamflat_attn_kernel(const __nv_bfloat16* __restrict__ q,
                     const uint8_t* __restrict__ k,
                     const __nv_bfloat16* __restrict__ ks,
                     const uint8_t* __restrict__ v,
                     const __nv_bfloat16* __restrict__ vs,
                     const int* __restrict__ anc,
                     __nv_bfloat16* __restrict__ out,
                     int n_head, int rows, int t_anc, int group, int limit) {
  constexpr int ROWB = BITS * HD / 8;
  __shared__ Smem sm;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t head = ((size_t)(b / group) * n_head + h) * rows;
  const size_t qoff = ((size_t)b * n_head + h) * HD;
  attend_row<BITS, INT_DOT>(q + qoff, k + head * ROWB, ks + head,
                                   v + head * ROWB, vs + head, limit,
                                   AncestryRow{anc + (size_t)b * t_anc, group},
                                   out + qoff, sm);
}

template <int BITS, bool INT_DOT>
void launch(dim3 grid, cudaStream_t s, const void* q, const void* k, const void* ks,
            const void* v, const void* vs, const void* anc, void* out, int n_head,
            int rows, int t_anc, int group, int limit) {
  beamflat_attn_kernel<BITS, INT_DOT><<<grid, THREADS, 0, s>>>(
      (const __nv_bfloat16*)q, (const uint8_t*)k, (const __nv_bfloat16*)ks,
      (const uint8_t*)v, (const __nv_bfloat16*)vs, (const int*)anc,
      (__nv_bfloat16*)out, n_head, rows, t_anc, group, limit);
}

}  // namespace

extern "C" int wmt_beamflat_attention(const void* q, const void* k, const void* ks,
                                      const void* v, const void* vs, const void* anc,
                                      void* out, int nb, int n_head, int rows,
                                      int t_anc, int group, int limit, int bits,
                                      int int_dot, void* stream) {
  if (group < 1 || nb < 1 || nb > 65535 || nb % group != 0 || n_head < 1 ||
      rows % group != 0 || limit < 1 || limit > rows / group || limit > t_anc ||
      limit > MAX_T) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(n_head, nb);
  cudaStream_t s = (cudaStream_t)stream;
  if (bits == 8 && !int_dot) {
    launch<8, false>(grid, s, q, k, ks, v, vs, anc, out, n_head, rows, t_anc, group, limit);
  } else if (bits == 4 && !int_dot) {
    launch<4, false>(grid, s, q, k, ks, v, vs, anc, out, n_head, rows, t_anc, group, limit);
  } else if (bits == 8) {
    launch<8, true>(grid, s, q, k, ks, v, vs, anc, out, n_head, rows, t_anc, group, limit);
  } else if (bits == 4) {
    launch<4, true>(grid, s, q, k, ks, v, vs, anc, out, n_head, rows, t_anc, group, limit);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
