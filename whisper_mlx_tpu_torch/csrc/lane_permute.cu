// Beam lane reorder of a layer's cache tensors for Hopper (sm_90a).
//
// Replaces: whisper_mlx_tpu/ops/lane_permute.py:permute_lanes (_perm_kernel,
// out of place: out[b] = in[parent[b]]) and lane_move_inplace (_move_kernel,
// in place: row b <- row src[b] where src[b] != b). Both are one kernel here:
// the move is the gather with src == dst that skips fixed rows.
//
// Every tensor's row is axis 0 of a contiguous tensor, so a lane's row is one
// contiguous byte span: (H, T, 64) int8 codes, (H, T, 32) packed int4 codes
// (plain bytes here, so int4 needs no other path), (H, T) bf16 scales or fp
// rows. Up to MAX_TENSORS tensors of a layer move in one launch.
//
// The move's precondition (whisper_mlx_tpu/ops/lane_permute.py:116-122):
// every source row is a fixed point, src[b] != b implies src[src[b]] ==
// src[b]. A row that is read is then never written, so blocks that run in
// parallel, in any order, cannot race. The permute writes another buffer and
// never reads a row it has written.
//
// What bounds it on the H100: device-memory bytes, each moved row read once
// and written once. Simple design: grid (chunks, lanes); a block copies its
// chunk of every tensor's row with 16-byte vector loads and stores (byte
// copies for a row length that is not a multiple of 16).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_TENSORS = 8;
constexpr int THREADS = 256;
constexpr int MAX_CHUNKS = 32;

struct Rows {
  const uint8_t* src[MAX_TENSORS];
  uint8_t* dst[MAX_TENSORS];
  long long bytes[MAX_TENSORS];
  int n;
};

__global__ void __launch_bounds__(THREADS)
lane_copy_kernel(Rows r, const int* __restrict__ from, int skip_fixed) {
  const int b = blockIdx.y;
  const int f = from[b];
  if (skip_fixed && f == b) return;
  const long long start = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  for (int i = 0; i < r.n; ++i) {
    const long long bytes = r.bytes[i];
    const uint8_t* s = r.src[i] + (size_t)f * bytes;
    uint8_t* d = r.dst[i] + (size_t)b * bytes;
    if ((bytes & 15) == 0) {
      const uint4* s4 = reinterpret_cast<const uint4*>(s);
      uint4* d4 = reinterpret_cast<uint4*>(d);
      for (long long j = start; j < bytes / 16; j += stride) d4[j] = s4[j];
    } else {
      for (long long j = start; j < bytes; j += stride) d[j] = s[j];
    }
  }
}

}  // namespace

// srcs/dsts/bytes: host arrays of n tensors (row bytes each); from: device
// int32 (nb,) row map. skip_fixed = 1 is the in-place move (srcs == dsts).
extern "C" int wmt_lane_copy(const void* const* srcs, void* const* dsts,
                             const long long* bytes, int n, const void* from,
                             int nb, int skip_fixed, void* stream) {
  if (n < 1 || n > MAX_TENSORS || nb < 1 || nb > 65535) return (int)cudaErrorInvalidValue;
  Rows r{};
  r.n = n;
  long long most = 0;
  for (int i = 0; i < n; ++i) {
    if (bytes[i] < 1) return (int)cudaErrorInvalidValue;
    r.src[i] = (const uint8_t*)srcs[i];
    r.dst[i] = (uint8_t*)dsts[i];
    r.bytes[i] = bytes[i];
    const long long units = (bytes[i] & 15) == 0 ? bytes[i] / 16 : bytes[i];
    most = units > most ? units : most;
  }
  long long chunks = (most + THREADS - 1) / THREADS;
  chunks = chunks < 1 ? 1 : (chunks > MAX_CHUNKS ? MAX_CHUNKS : chunks);
  const dim3 grid((unsigned)chunks, nb);
  lane_copy_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(r, (const int*)from,
                                                                skip_fixed);
  return (int)cudaGetLastError();
}
