// Fused log-mel frontend for Hopper (sm_90a).
//
// Replaces: whisper_mlx_tpu/ops/mel_pallas.py:log_mel_pallas (_mel_kernel),
// the Pallas TPU kernel behind audio/mel.py's backend="pallas".
//
// Computes, for frames (n_frames, 400) fp32 that already carry the reflect
// padding and hop-160 framing:
//     re = frames . cos_basis,  im = frames . sin_basis   (Hann folded in)
//     power = re^2 + im^2
//     out = log10(max(power . fb^T, 1e-10))               (n_frames, n_mels)
// The global max-8 clamp and (x+4)/4 stay outside, as on the TPU.
//
// What bounds it on the H100: fp32 FMA. One 30 s window is 3000 frames x
// 400 samples x 208 bins x 2 (re, im) FMAs plus 3000 x 208 x 128 for the
// filterbank, about 1.1 GFLOP. The reference runs at Precision.HIGHEST, so
// no TF32 or bf16 tensor-core path is allowed: every product is an fp32 FMA.
//
// Simple design: a block owns TF=16 frames. The frame tile (25.6 KB) and the
// power spectrum (16 KB) live in shared memory; each thread owns one
// frequency bin and keeps 16 re and 16 im accumulators in registers, so each
// basis value is read once per block and used for 16 frames. The bases and
// filterbank (0.77 MB) stay resident in L2 across blocks. The bins are padded
// from 201 to a multiple of 16 with zero columns by the caller.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int N_FFT = 400;
constexpr int TF = 16;
constexpr int THREADS = 256;
constexpr int MAX_BINS = 256;

__global__ void __launch_bounds__(THREADS)
log_mel_kernel(const float* __restrict__ frames,
               const float* __restrict__ cos_b,
               const float* __restrict__ sin_b,
               const float* __restrict__ fb_t,
               float* __restrict__ out,
               int n_frames, int n_bins, int n_mels) {
  __shared__ float xs[TF][N_FFT];
  __shared__ float pw[TF][MAX_BINS + 1];
  const int f0 = blockIdx.x * TF;
  const int tid = threadIdx.x;

  for (int i = tid; i < TF * N_FFT; i += THREADS) {
    const int f = i / N_FFT;
    const int n = i - f * N_FFT;
    xs[f][n] = (f0 + f < n_frames) ? frames[(size_t)(f0 + f) * N_FFT + n] : 0.f;
  }
  __syncthreads();

  for (int k = tid; k < n_bins; k += THREADS) {
    float re[TF], im[TF];
#pragma unroll
    for (int f = 0; f < TF; ++f) {
      re[f] = 0.f;
      im[f] = 0.f;
    }
    for (int n = 0; n < N_FFT; ++n) {
      const float c = __ldg(cos_b + n * n_bins + k);
      const float s = __ldg(sin_b + n * n_bins + k);
#pragma unroll
      for (int f = 0; f < TF; ++f) {
        const float x = xs[f][n];
        re[f] = fmaf(x, c, re[f]);
        im[f] = fmaf(x, s, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < TF; ++f) pw[f][k] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  for (int m = tid; m < n_mels; m += THREADS) {
    float acc[TF];
#pragma unroll
    for (int f = 0; f < TF; ++f) acc[f] = 0.f;
    for (int k = 0; k < n_bins; ++k) {
      const float w = __ldg(fb_t + k * n_mels + m);
#pragma unroll
      for (int f = 0; f < TF; ++f) acc[f] = fmaf(pw[f][k], w, acc[f]);
    }
#pragma unroll
    for (int f = 0; f < TF; ++f) {
      if (f0 + f < n_frames) {
        out[(size_t)(f0 + f) * n_mels + m] = log10f(fmaxf(acc[f], 1e-10f));
      }
    }
  }
}

}  // namespace

extern "C" int wmt_log_mel(const void* frames, const void* cos_b,
                           const void* sin_b, const void* fb_t, void* out,
                           int n_frames, int n_bins, int n_mels,
                           void* stream) {
  if (n_bins > MAX_BINS || n_bins < 1 || n_mels < 1 || n_frames < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((n_frames + TF - 1) / TF);
  log_mel_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)frames, (const float*)cos_b, (const float*)sin_b,
      (const float*)fb_t, (float*)out, n_frames, n_bins, n_mels);
  return (int)cudaGetLastError();
}
