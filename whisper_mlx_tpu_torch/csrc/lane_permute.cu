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
// and written once. The row map stays on the device (no host read, no
// synchronisation), so the host cannot size the grid to the moved lanes.
// Design: a grid sized to the card (MAX_BLOCKS_PER_SM blocks an SM). Each
// block reads the whole map once and lists the moved lanes (all of them for
// the permute) in shared memory; the moved lanes' rows of every tensor whose
// row length is a multiple of 16, laid end to end, are cut into one equal
// range of 16-byte units a block, so blocks carry equal bytes however many
// lanes move. One thread of each block walks its range in pieces of up to
// CHUNK bytes through a ring of STAGES shared buffers: a bulk copy
// (cp.async.bulk) global -> shared completing on the stage's mbarrier, then
// a bulk copy shared -> global in a bulk group; all STAGES loads are in
// flight before the first store, and a stage is loaded again once the
// stores have read it. Rows whose length is not a multiple of 16 are copied
// byte by byte by every thread of the grid.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_async.cuh"

namespace {

using namespace wmt_async;

constexpr int MAX_TENSORS = 8;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 8192;   // bytes a piece
constexpr int STAGES = 6;     // pieces in flight a block
constexpr int MAX_BLOCKS_PER_SM = 2;
constexpr unsigned FULL = 0xffffffffu;

struct Rows {
  const uint8_t* src[MAX_TENSORS];
  uint8_t* dst[MAX_TENSORS];
  long long bytes[MAX_TENSORS];
  int n;
};

struct Smem {
  alignas(128) uint8_t stage[STAGES][CHUNK];
  alignas(8) uint64_t bar[STAGES];
  uint8_t* dst[STAGES];  // where each stage's piece goes
  uint32_t size[STAGES];
  int count[WARPS];
  // then the moved lanes in order: lane and its source lane, nb of each
};

__global__ void __launch_bounds__(THREADS)
lane_copy_kernel(Rows r, const int* __restrict__ from, int nb, int skip_fixed) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  uint16_t* lane_of = reinterpret_cast<uint16_t*>(smem_raw + sizeof(Smem));
  uint16_t* src_of = lane_of + nb;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&sm.bar[s], 1);
    mbar_fence_init();
  }
  // the moved lanes, in lane order
  int moved = 0;
  for (int base = 0; base < nb; base += THREADS) {
    const int b = base + tid;
    const int f = b < nb ? from[b] : 0;
    const bool mv = b < nb && !(skip_fixed && f == b);
    const unsigned ball = __ballot_sync(FULL, mv);
    if (lane == 0) sm.count[warp] = __popc(ball);
    __syncthreads();
    int at = moved + __popc(ball & ((1u << lane) - 1u));
    int tile = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      at += w < warp ? sm.count[w] : 0;
      tile += sm.count[w];
    }
    if (mv) {
      lane_of[at] = (uint16_t)b;
      src_of[at] = (uint16_t)f;
    }
    moved += tile;
    __syncthreads();
  }

  // this block's range of the moved rows' 16-byte units
  long long lane_units = 0;
  for (int i = 0; i < r.n; ++i) lane_units += (r.bytes[i] & 15) == 0 ? r.bytes[i] / 16 : 0;
  const long long total = (long long)moved * lane_units;
  const long long u0 = (long long)blockIdx.x * total / gridDim.x;
  const long long u1 = (long long)(blockIdx.x + 1) * total / gridDim.x;
  if (tid == 0 && u1 > u0) {
    long long u = u0;  // the next unit to load
    // the next piece from unit u: within one tensor's row, at most CHUNK bytes
    auto next = [&](const uint8_t*& src, uint8_t*& dst, uint32_t& size) {
      const long long o = u / lane_units;
      long long in_lane = u - o * lane_units;
      int i = 0;
      for (;; ++i) {
        const long long units = (r.bytes[i] & 15) == 0 ? r.bytes[i] / 16 : 0;
        if (in_lane < units) break;
        in_lane -= units;
      }
      const long long row_units = r.bytes[i] / 16;
      const long long n = min(min(row_units - in_lane, u1 - u), (long long)(CHUNK / 16));
      src = r.src[i] + (size_t)src_of[o] * r.bytes[i] + in_lane * 16;
      dst = r.dst[i] + (size_t)lane_of[o] * r.bytes[i] + in_lane * 16;
      size = (uint32_t)(n * 16);
      u += n;
    };
    auto load = [&](int s) {
      const uint8_t* src;
      next(src, sm.dst[s], sm.size[s]);
      mbar_expect_tx(&sm.bar[s], sm.size[s]);
      bulk_load(sm.stage[s], src, sm.size[s], &sm.bar[s]);
    };
    int issued = 0;
    while (issued < STAGES && u < u1) load(issued++);
    for (int done = 0; done < issued; ++done) {
      const int s = done % STAGES;
      mbar_wait(&sm.bar[s], (uint32_t)(done / STAGES) & 1u);
      bulk_store(sm.dst[s], sm.stage[s], sm.size[s]);
      bulk_commit();
      if (u < u1) {
        bulk_wait_read();  // the store has read the stage
        load(issued++ % STAGES);
      }
    }
    bulk_wait();
  }

  // rows whose length is not a multiple of 16, a byte a thread
  const long long stride = (long long)gridDim.x * THREADS;
  for (int i = 0; i < r.n; ++i) {
    const long long bytes = r.bytes[i];
    if ((bytes & 15) == 0) continue;
    for (long long j = (long long)blockIdx.x * THREADS + tid; j < moved * bytes; j += stride) {
      const long long o = j / bytes;
      const long long c = j - o * bytes;
      r.dst[i][(size_t)lane_of[o] * bytes + c] = r.src[i][(size_t)src_of[o] * bytes + c];
    }
  }
}

int blocks_for_device() {
  static int sms[MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < MAX_DEVICES && sms[dev] > 0) return MAX_BLOCKS_PER_SM * sms[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (dev < MAX_DEVICES) sms[dev] = n;
  return MAX_BLOCKS_PER_SM * n;
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
  long long units = 0;
  for (int i = 0; i < n; ++i) {
    if (bytes[i] < 1) return (int)cudaErrorInvalidValue;
    r.src[i] = (const uint8_t*)srcs[i];
    r.dst[i] = (uint8_t*)dsts[i];
    r.bytes[i] = bytes[i];
    units += (bytes[i] + 15) / 16;
  }
  const int most = blocks_for_device();
  if (most < 1) return (int)cudaErrorInvalidDevice;
  // no more blocks than pieces if every lane moved
  const long long pieces = (long long)nb * ((units * 16 + CHUNK - 1) / CHUNK);
  const int blocks = (int)(pieces < most ? pieces : most);
  const int smem = (int)sizeof(Smem) + 4 * nb;
  const cudaError_t e = allow_smem<lane_copy_kernel>(smem);
  if (e != cudaSuccess) return (int)e;
  lane_copy_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(r, (const int*)from, nb,
                                                                    skip_fixed);
  return (int)cudaGetLastError();
}
