// Decode attention over a quantized KV cache for Hopper (sm_90a).
//
// Replaces: whisper_mlx_tpu/ops/decode_attention.py:decode_attention_int8
// (_decode_dma_kernel for Tq=1, _decode_attn_kernel for Tq>1), the same
// function as ops/kv_quant.py:attention_int8_auto and, with a group g > 1,
// attention_int8_grouped.
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
// 20 heads x 32 layers per row, and the dot products are 2 FLOPs per code,
// far below the card's FLOP/byte balance.
//
// Simple design: one block of 128 threads per (query row, head). Four
// threads share one key row (16 codes each, one 16-byte int8 load or one
// 8-byte int4 load), so a warp reads 8 whole rows per instruction. Scores go
// to shared memory, block reductions give the max and the sum, and the
// weighted sum of V is reduced across the 32 key lanes in shared memory.
// The key loop stops at min(pos + i + 1, valid_len): dead cache positions
// are never read. Split-K over the 1500 cross positions is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;
constexpr int THREADS = 128;
constexpr int KEY_LANES = THREADS / 4;
constexpr int MAX_T = 2048;
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

template <int BITS>
__device__ __forceinline__ void load_codes(const uint8_t* row, int part,
                                           float (&c)[16]) {
  if constexpr (BITS == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + part * 16);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int j = 0; j < 16; ++j) c[j] = (float)b[j];
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(row + part * 8);
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int lo = ((int)(int8_t)(uint8_t)(b[j] << 4)) >> 4;
      const int hi = ((int)(int8_t)b[j]) >> 4;
      c[2 * j] = (float)lo;
      c[2 * j + 1] = (float)hi;
    }
  }
}

template <bool IS_MAX>
__device__ __forceinline__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(FULL, x, off);
    x = IS_MAX ? fmaxf(x, o) : x + o;
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) r = IS_MAX ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();
  return r;
}

template <int BITS>
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
  __shared__ float qs[HD];
  __shared__ float w[MAX_T];
  __shared__ float part_out[KEY_LANES][HD + 1];
  __shared__ float red[THREADS / 32];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int key_lane = tid >> 2;
  const int part = tid & 3;
  const size_t head = ((size_t)(b / group) * n_head + h) * t_alloc;
  const uint8_t* kh = k + head * ROWB;
  const uint8_t* vh = v + head * ROWB;
  const __nv_bfloat16* ksh = ks + head;
  const __nv_bfloat16* vsh = vs + head;

  for (int i = 0; i < tq; ++i) {
    const size_t qoff = (((size_t)b * n_head + h) * tq + i) * HD;
    const int limit = causal ? min(pos + i + 1, valid_len) : valid_len;
    __syncthreads();
    if (tid < HD) qs[tid] = __bfloat162float(q[qoff + tid]);
    __syncthreads();
    float qreg[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) qreg[j] = qs[part * 16 + j];

    float m_loc = NEG;
    for (int base = 0; base < limit; base += KEY_LANES) {
      const int t = base + key_lane;
      float dot = 0.f;
      if (t < limit) {
        float c[16];
        load_codes<BITS>(kh + (size_t)t * ROWB, part, c);
#pragma unroll
        for (int j = 0; j < 16; ++j) dot = fmaf(qreg[j], c[j], dot);
      }
      dot += __shfl_xor_sync(FULL, dot, 1);
      dot += __shfl_xor_sync(FULL, dot, 2);
      if (t < limit && part == 0) {
        const float s = dot * __bfloat162float(ksh[t]);
        w[t] = s;
        m_loc = fmaxf(m_loc, s);
      }
    }
    const float m = block_reduce<true>(m_loc, red);
    float l_loc = 0.f;
    for (int t = tid; t < limit; t += THREADS) {
      const float p = expf(w[t] - m);
      w[t] = p;
      l_loc += p;
    }
    const float l = block_reduce<false>(l_loc, red);
    for (int t = tid; t < limit; t += THREADS) {
      const float wv = w[t] / l * __bfloat162float(vsh[t]);
      w[t] = __bfloat162float(__float2bfloat16(wv));
    }
    __syncthreads();

    float acc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = 0.f;
    for (int t = key_lane; t < limit; t += KEY_LANES) {
      float c[16];
      load_codes<BITS>(vh + (size_t)t * ROWB, part, c);
      const float wt = w[t];
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[j] = fmaf(wt, c[j], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) part_out[key_lane][part * 16 + j] = acc[j];
    __syncthreads();
    if (tid < HD) {
      float o = 0.f;
      for (int r = 0; r < KEY_LANES; ++r) o += part_out[r][tid];
      out[qoff + tid] = __float2bfloat16(o);
    }
  }
}

}  // namespace

extern "C" int wmt_decode_attention(const void* q, const void* k,
                                    const void* ks, const void* v,
                                    const void* vs, void* out, int bq,
                                    int n_head, int tq, int t_alloc, int group,
                                    int pos, int causal, int valid_len,
                                    int bits, void* stream) {
  if (t_alloc > MAX_T || valid_len < 1 || valid_len > t_alloc || group < 1 ||
      bq < 1 || bq > 65535 || n_head < 1 || tq < 1 || pos < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(n_head, bq);
  cudaStream_t s = (cudaStream_t)stream;
  if (bits == 8) {
    decode_attn_kernel<8><<<grid, THREADS, 0, s>>>(
        (const __nv_bfloat16*)q, (const uint8_t*)k, (const __nv_bfloat16*)ks,
        (const uint8_t*)v, (const __nv_bfloat16*)vs, (__nv_bfloat16*)out,
        n_head, tq, t_alloc, group, pos, causal, valid_len);
  } else if (bits == 4) {
    decode_attn_kernel<4><<<grid, THREADS, 0, s>>>(
        (const __nv_bfloat16*)q, (const uint8_t*)k, (const __nv_bfloat16*)ks,
        (const uint8_t*)v, (const __nv_bfloat16*)vs, (__nv_bfloat16*)out,
        n_head, tq, t_alloc, group, pos, causal, valid_len);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
