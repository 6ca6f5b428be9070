// Fused log-mel frontend (kernel K1) for Hopper (sm_90a).
//
// Replaces: whisper_mlx_tpu/ops/mel_pallas.py:log_mel_pallas (_mel_kernel),
// the Pallas TPU kernel behind audio/mel.py's backend="pallas".
//
// Computes, for frames (n_frames, 400) fp32 that already carry the reflect
// padding and hop-160 framing:
//     re = frames . cos_basis,  im = frames . sin_basis   (Hann folded in)
//     power = re^2 + im^2                                  (208 padded bins)
//     out = log10(max(power . fb^T, 1e-10))               (n_frames, n_mels)
// The global max-8 clamp and (x+4)/4 stay outside, as on the TPU.
//
// What bounds it on the H100: fp32 FMA. One 30 s window is 3000 frames x
// 400 samples x 208 bins x 2 (re, im) FMAs plus the filterbank, about 1.1
// GFLOP. The reference runs at Precision.HIGHEST, so no TF32, 3xTF32 or
// bf16 tensor-core path, no FFT and no folding of the symmetric window:
// every product of the direct DFT is an fp32 FMA.
//
// Design (the first form, one block of 16 frames a tile, ran 188 blocks:
// 1.4 waves on 132 SMs, a thread reading the bases from L2 a float at a
// time, slower than its own plain version):
// - A cluster of CB = 4 blocks takes TF = 32 frames; block r of it the bins
//   [52 r, 52 r + 52): 376 blocks at 3000 frames, three resident an SM (74
//   KB of shared memory, 128 threads each), so one wave fills the card.
// - A ring of 3 stages of 40 k holds the frames' k slice (32 x 40, rows
//   padded to 44 floats: the eight rows a phase of a 16-byte load reads
//   fall on distinct banks), copied 16 bytes a thread by cp.async, and the
//   block's bases (40 x 104 floats, each bin's cosine and sine side by
//   side, contiguous for the block in the wrapper's table), one bulk copy
//   (cp.async.bulk) completing on the stage's mbarrier.
// - Register tiles: 104 threads each hold 4 frames (fg + 8 i) x 4 bins x
//   (re, im), 32 accumulators, summed over k in order, as the plain
//   version's GEMMs sum: a float4 of each frame's next 4 samples and two
//   float4s of bases a k feed 32 FMAs. Larger tiles (8 frames x 4 bins)
//   leave too few warps an SM at 3000 frames unless k is split between
//   threads, and a split's other order of the sums moved rare low-energy
//   frames past the 2e-4 the kernel is held to.
// - The power spectra go to shared memory; after a cluster barrier each
//   block gathers the cluster's 32 x 208 spectra through distributed shared
//   memory (float4 reads), and computes a quarter of the mels: each mel sums
//   only its filter's nonzero bins [lo, hi) (the wrapper's table), in bin
//   order, which for finite frames is bit-for-bit the dense loop's sum.
// Sums run in one fixed order: a repeat is bit-equal.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_async.cuh"

namespace {

using namespace wmt_async;

constexpr int N_FFT = 400;
constexpr int BINS = 208;           // 201 rfft bins padded with zero columns
constexpr int CB = 4;               // blocks of a cluster, along the bins
constexpr int BB = BINS / CB;       // bins a block: 52
constexpr int BCOL = 2 * BB;        // basis columns a block (cos, sin): 104
constexpr int TF = 32;              // frames a cluster
constexpr int THREADS = 128;
constexpr int FG = 8;               // frame groups: thread frames fg + FG i
constexpr int FPT = TF / FG;        // frames a thread: 4
constexpr int WORKERS = (BB / 4) * FG;  // threads of the DFT: 13 bin groups x 8
constexpr int KC = 40;              // k of a ring stage
constexpr int NCH = N_FFT / KC;     // stages: 10
constexpr int STAGES = 3;
constexpr int FS = KC + 4;          // frame row stride in shared memory (floats)
constexpr int XF = TF * FS;         // floats of a stage's frames
constexpr int STAGE = XF + KC * BCOL;  // floats of a stage
constexpr int PW = STAGES * STAGE;     // the block's spectra: TF x BB floats
constexpr int BARS = PW + TF * BB;     // the stages' full barriers
constexpr int SMEM = BARS * 4 + STAGES * 8;
static_assert(TF * BINS <= PW, "the ring holds the gathered spectra");
static_assert(BARS % 2 == 0, "the barriers need 8-byte alignment");

// one 4-k step's operands of a thread: its frames' samples, its 4 bins'
// (cos, sin) at each k
struct Step {
  float4 x[FPT];
  float4 b[4][2];
};

__device__ __forceinline__ void load_step(Step& o, const float* xs, const float* bs, int kk,
                                          int fg, int bg) {
#pragma unroll
  for (int i = 0; i < FPT; ++i) o.x[i] = *reinterpret_cast<const float4*>(xs + (fg + FG * i) * FS + kk);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    o.b[q][0] = *reinterpret_cast<const float4*>(bs + (kk + q) * BCOL + 8 * bg);
    o.b[q][1] = *reinterpret_cast<const float4*>(bs + (kk + q) * BCOL + 8 * bg + 4);
  }
}

__device__ __forceinline__ void fma_step(const Step& o, float (&re)[FPT][4], float (&im)[FPT][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 b0 = o.b[q][0], b1 = o.b[q][1];
#pragma unroll
    for (int i = 0; i < FPT; ++i) {
      const float x = q == 0 ? o.x[i].x : q == 1 ? o.x[i].y : q == 2 ? o.x[i].z : o.x[i].w;
      re[i][0] = fmaf(x, b0.x, re[i][0]);
      im[i][0] = fmaf(x, b0.y, im[i][0]);
      re[i][1] = fmaf(x, b0.z, re[i][1]);
      im[i][1] = fmaf(x, b0.w, im[i][1]);
      re[i][2] = fmaf(x, b1.x, re[i][2]);
      im[i][2] = fmaf(x, b1.y, im[i][2]);
      re[i][3] = fmaf(x, b1.z, re[i][3]);
      im[i][3] = fmaf(x, b1.w, im[i][3]);
    }
  }
}

// Frames [32 c, 32 c + 32) of cluster c = blockIdx.y; block rank r = blockIdx.x.
// basis: (CB, 400, 104), block r's columns contiguous.
__global__ void __launch_bounds__(THREADS, 3)
log_mel_kernel(const float* __restrict__ frames, const float* __restrict__ basis,
               const float* __restrict__ fb_t, const int2* __restrict__ ranges,
               float* __restrict__ out, int n_frames, int n_mels) {
  extern __shared__ __align__(16) float sm[];
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + BARS);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int f0 = blockIdx.y * TF;
  const int tid = threadIdx.x;
  const float* bsrc = basis + (size_t)rank * N_FFT * BCOL;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  // stage c into its slot: the frames' k slice by every thread's cp.async
  // (frames past the end zero), one committed group a call, and the
  // block's bases by thread 0's bulk copy on the slot's barrier
  auto issue = [&](int c) {
    if (c < NCH) {
      float* st = sm + (c % STAGES) * STAGE;
      if (tid == 0) {
        mbar_expect_tx(&full[c % STAGES], KC * BCOL * 4);
        bulk_load(st + XF, bsrc + (size_t)c * KC * BCOL, KC * BCOL * 4, &full[c % STAGES]);
      }
      for (int i = tid; i < TF * (KC / 4); i += THREADS) {
        const int f = i / (KC / 4), q = i % (KC / 4);
        const bool ok = f0 + f < n_frames;
        cp_async16(st + f * FS + 4 * q,
                   ok ? frames + (size_t)(f0 + f) * N_FFT + c * KC + 4 * q : frames, ok);
      }
    }
    cp_async_commit();  // one group a call, empty or not, so the count holds
  };
  for (int c = 0; c < STAGES - 1; ++c) issue(c);

  const int fg = tid % FG;  // frames fg + 8 i
  const int bg = tid / FG;  // bins 4 bg .. 4 bg + 3 of the block
  const bool worker = tid < WORKERS;
  float re[FPT][4], im[FPT][4];
#pragma unroll
  for (int i = 0; i < FPT; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;
  }
  for (int c = 0; c < NCH; ++c) {
    cp_async_wait(STAGES - 2);  // this thread's frame copies of stage c have landed
    mbar_wait(&full[c % STAGES], (c / STAGES) & 1);  // ... and the bases
    __syncthreads();  // every thread's copies; every thread is done with stage c - 1
    if (tid == 0) fence_proxy_async();  // the generic reads of stage c - 1 before a bulk copy
    issue(c + STAGES - 1);  // into stage c - 1's slot
    if (worker) {
      const float* xs = sm + (c % STAGES) * STAGE;
      const float* bs = xs + XF;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 4) {
        Step o;
        load_step(o, xs, bs, kk, fg, bg);
        fma_step(o, re, im);
      }
    }
  }
  cp_async_wait(0);

  // the block's power spectra, then the cluster's gathered into the ring
  float* pw = sm + PW;  // (TF, BB)
  if (worker) {
#pragma unroll
    for (int i = 0; i < FPT; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pw[(fg + FG * i) * BB + 4 * bg + j] = re[i][j] * re[i][j] + im[i][j] * im[i][j];
      }
    }
  }
  cluster.sync();
  float* spec = sm;  // (TF, BINS)
  for (int i = tid; i < CB * TF * (BB / 4); i += THREADS) {
    const int src = i / (TF * (BB / 4));
    const int f = (i / (BB / 4)) % TF;
    const int q = i % (BB / 4);
    const float* remote = cluster.map_shared_rank(pw, src);
    *reinterpret_cast<float4*>(spec + f * BINS + src * BB + 4 * q) =
        *reinterpret_cast<const float4*>(remote + f * BB + 4 * q);
  }
  cluster.sync();  // every block's reads of the others' spectra are done

  // mels [rank * mpb, (rank + 1) * mpb) of the cluster's frames
  const int mpb = (n_mels + CB - 1) / CB;
  for (int o = tid; o < TF * mpb; o += THREADS) {
    const int f = o / mpb;
    const int mel = rank * mpb + o % mpb;
    if (mel >= n_mels || f0 + f >= n_frames) continue;
    const int2 r = __ldg(ranges + mel);
    float acc = 0.f;
    for (int b = r.x; b < r.y; ++b) acc = fmaf(spec[f * BINS + b], __ldg(fb_t + b * n_mels + mel), acc);
    out[(size_t)(f0 + f) * n_mels + mel] = log10f(fmaxf(acc, 1e-10f));
  }
}

}  // namespace

extern "C" int wmt_log_mel(const void* frames, const void* basis, const void* fb_t,
                           const void* ranges, void* out, int n_frames, int n_bins, int n_mels,
                           void* stream) {
  if (n_bins != BINS || n_mels < 1 || n_frames < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(CB, (n_frames + TF - 1) / TF);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  return (int)launch_cluster<log_mel_kernel>(
      grid, THREADS, SMEM, CB, (cudaStream_t)stream, (const float*)frames, (const float*)basis,
      (const float*)fb_t, (const int2*)ranges, (float*)out, n_frames, n_mels);
}
