// One query row's attention over a quantized cache, the row loop of the
// beam-flat kernel (K8, beamflat_attention.cu). A block of THREADS threads
// serves one (row, head); the caller says which cache row holds key t
// (`row_of`): K8 gathers one row per position through the beam ancestry.
//
// Two modes:
//   fp (INT_DOT = false)  s_t = (q . k_t) * ks_t in fp32; w = softmax(s);
//                         out = sum_t (w_t vs_t) v_t in fp32, w_t vs_t kept
//                         fp32
//   int (INT_DOT = true)  whisper_mlx_tpu/ops/kv_quant.py:attention_int8_mxu:
//                         q re-quantized per row over d (absmax/127, round
//                         half to even, clip +-127); s_t = s32 * qs * ks_t
//                         with s32 an s8 x s8 -> s32 dot (__dp4a; int4 codes
//                         widen to s8); w = softmax(s); wv = w * vs is
//                         re-quantized over the row's keys the same way; out
//                         = (sum_t w8_t v_t, exact in int32) * ws
//
// Thread layout: four threads share one key row (16 of the 64 dims each, one
// 16-byte int8 load or one 8-byte int4 load), so a warp reads 8 rows per
// instruction. Scores live in shared memory `w`, which is what the integer
// mode needs: the absmax of w * vs over every key comes before the PV dot.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace wmt_attn {

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

// The thread's 16 codes as s8, four to an int in dim order (for __dp4a).
template <int BITS>
__device__ __forceinline__ void load_codes_s8(const uint8_t* row, int part,
                                              int (&c)[4]) {
  if constexpr (BITS == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + part * 16);
    c[0] = (int)raw.x;
    c[1] = (int)raw.y;
    c[2] = (int)raw.z;
    c[3] = (int)raw.w;
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(row + part * 8);
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint8_t byte = b[2 * m + j];
        const uint32_t lo = (uint32_t)(uint8_t)(((int8_t)(uint8_t)(byte << 4)) >> 4);
        const uint32_t hi = (uint32_t)(uint8_t)(((int8_t)byte) >> 4);
        word |= (lo | (hi << 8)) << (16 * j);
      }
      c[m] = (int)word;
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

// Per-row symmetric int8 code of x under scale (absmax/127 recipe).
__device__ __forceinline__ float quantize_code(float x, float scale) {
  return fminf(fmaxf(rintf(x / scale), -127.f), 127.f);
}

struct Smem {
  float qs[HD];
  float w[MAX_T];
  float part_out[KEY_LANES][HD + 1];
  float red[THREADS / 32];
};

// Attend one query row `qrow` (HD bf16) over keys t < limit, key t at cache
// row row_of(t) of the head's codes (kh, vh) and scales (ksh, vsh); writes
// HD bf16 to orow. Every thread of the block calls it.
template <int BITS, bool INT_DOT, class RowOf>
__device__ __forceinline__ void attend_row(
    const __nv_bfloat16* __restrict__ qrow, const uint8_t* __restrict__ kh,
    const __nv_bfloat16* __restrict__ ksh, const uint8_t* __restrict__ vh,
    const __nv_bfloat16* __restrict__ vsh, int limit, RowOf row_of,
    __nv_bfloat16* __restrict__ orow, Smem& sm) {
  constexpr int ROWB = BITS * HD / 8;
  const int tid = threadIdx.x;
  const int key_lane = tid >> 2;
  const int part = tid & 3;

  __syncthreads();
  if (tid < HD) sm.qs[tid] = __bfloat162float(qrow[tid]);
  __syncthreads();
  float qreg[16];
  int q8[4];
  float qscale = 1.f;
  if constexpr (INT_DOT) {
    const float amax = block_reduce<true>(tid < HD ? fabsf(sm.qs[tid]) : 0.f, sm.red);
    qscale = fmaxf(amax, 1e-30f) / 127.f;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int code = (int)quantize_code(sm.qs[part * 16 + 4 * m + j], qscale);
        word |= ((uint32_t)(uint8_t)(int8_t)code) << (8 * j);
      }
      q8[m] = (int)word;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) qreg[j] = sm.qs[part * 16 + j];
  }

  float m_loc = NEG;
  for (int base = 0; base < limit; base += KEY_LANES) {
    const int t = base + key_lane;
    const int row = t < limit ? row_of(t) : 0;
    float s;
    if constexpr (INT_DOT) {
      int dot = 0;
      if (t < limit) {
        int c[4];
        load_codes_s8<BITS>(kh + (size_t)row * ROWB, part, c);
#pragma unroll
        for (int m = 0; m < 4; ++m) dot = __dp4a(q8[m], c[m], dot);
      }
      dot += __shfl_xor_sync(FULL, dot, 1);
      dot += __shfl_xor_sync(FULL, dot, 2);
      s = (float)dot * qscale;
    } else {
      float dot = 0.f;
      if (t < limit) {
        float c[16];
        load_codes<BITS>(kh + (size_t)row * ROWB, part, c);
#pragma unroll
        for (int j = 0; j < 16; ++j) dot = fmaf(qreg[j], c[j], dot);
      }
      dot += __shfl_xor_sync(FULL, dot, 1);
      dot += __shfl_xor_sync(FULL, dot, 2);
      s = dot;
    }
    if (t < limit && part == 0) {
      s = s * __bfloat162float(ksh[row]);
      sm.w[t] = s;
      m_loc = fmaxf(m_loc, s);
    }
  }
  const float m = block_reduce<true>(m_loc, sm.red);
  float l_loc = 0.f;
  for (int t = tid; t < limit; t += THREADS) {
    const float p = expf(sm.w[t] - m);
    sm.w[t] = p;
    l_loc += p;
  }
  const float l = block_reduce<false>(l_loc, sm.red);
  float a_loc = 0.f;
  for (int t = tid; t < limit; t += THREADS) {
    const float wv = sm.w[t] / l * __bfloat162float(vsh[row_of(t)]);
    sm.w[t] = wv;
    a_loc = fmaxf(a_loc, fabsf(wv));
  }
  float wscale = 1.f;
  if constexpr (INT_DOT) {
    const float amax = block_reduce<true>(a_loc, sm.red);
    wscale = fmaxf(amax, 1e-30f) / 127.f;
    for (int t = tid; t < limit; t += THREADS) sm.w[t] = quantize_code(sm.w[t], wscale);
  }
  __syncthreads();

  if constexpr (INT_DOT) {
    int acc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = 0;
    for (int t = key_lane; t < limit; t += KEY_LANES) {
      float c[16];
      load_codes<BITS>(vh + (size_t)row_of(t) * ROWB, part, c);
      const int wt = (int)sm.w[t];
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[j] += wt * (int)c[j];
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) sm.part_out[key_lane][part * 16 + j] = __int_as_float(acc[j]);
    __syncthreads();
    if (tid < HD) {
      int o = 0;
      for (int r = 0; r < KEY_LANES; ++r) o += __float_as_int(sm.part_out[r][tid]);
      orow[tid] = __float2bfloat16((float)o * wscale);
    }
  } else {
    float acc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = 0.f;
    for (int t = key_lane; t < limit; t += KEY_LANES) {
      float c[16];
      load_codes<BITS>(vh + (size_t)row_of(t) * ROWB, part, c);
      const float wt = sm.w[t];
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[j] = fmaf(wt, c[j], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) sm.part_out[key_lane][part * 16 + j] = acc[j];
    __syncthreads();
    if (tid < HD) {
      float o = 0.f;
      for (int r = 0; r < KEY_LANES; ++r) o += sm.part_out[r][tid];
      orow[tid] = __float2bfloat16(o);
    }
  }
}

}  // namespace wmt_attn
