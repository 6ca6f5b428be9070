// Asynchronous copies and thread-block clusters on Hopper (sm_90a), shared by
// the few-row dequant-matmul (K5, quant_matmul.cu), the transposed
// dequant-matmul (K6, quant_matmul_mb.cu), their tiled core
// (quant_tile.cuh), the W8A8 matmul (K7, a8_matmul.cu), the decode
// attention (K3, decode_attention.cu) and the attention core of K2 and K4
// (attn_tile.cuh):
// - cp.async of 16 bytes into shared memory, committed and waited on in
//   groups (a ring of stages) or completing on an mbarrier;
// - one-dimensional bulk copies (cp.async.bulk, no tensor map) in both
//   directions (shared -> global in bulk groups, the lane move K9,
//   lane_permute.cu) and
//   two-dimensional TMA boxes (cp.async.bulk.tensor, tensor maps encoded on
//   the host through cudaGetDriverEntryPoint, so no -lcuda) completing
//   their bytes on an mbarrier;
// - allow_smem: a kernel's dynamic shared-memory limit, raised once a device;
// - launch_cluster: a launch through cudaLaunchKernelEx with a cluster
//   attribute.
// Cluster barriers and reads of a neighbour's shared memory go through
// cooperative_groups::this_cluster() (sync, map_shared_rank).
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wmt_async {

namespace cg = cooperative_groups;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; when !valid the 16 bytes are filled with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes));
}

// 16 bytes into shared memory from the first `src_bytes` (0..16) at src,
// the rest filled with zeros
__device__ __forceinline__ void cp_async16_part(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes));
}

// 4 bytes into shared memory from the first `src_bytes` (0..4) at src, the
// rest filled with zeros (both addresses 4-byte aligned)
__device__ __forceinline__ void cp_async4_part(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `pending` of this thread's copy groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::); break;
  }
}

// arrive on `bar` once every cp.async this thread has issued so far has
// landed (the arrival is counted in the barrier's expected count)
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// make the barriers' initialisation visible to the async proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// A block may write another block's shared memory only once that block
// has started (CUDA programming guide, distributed shared memory): an
// earlier write can fault. Every thread arrives (relaxed: no memory order)
// when the block starts and waits before its block's first remote access,
// so the wait rarely stalls; both are cluster-wide barriers, executed by
// every thread of the block, and a wait must follow each arrive.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) global ->
// shared, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) shared ->
// global, in this thread's current bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until every bulk group of this thread has read its shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// wait until every bulk group of this thread is complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Order this thread's view of shared memory, after an mbarrier wait that
// saw the consumers' reads of a ring stage, before the async proxy (TMA)
// writes the stage again: without it a TMA box can land over data that
// generic loads have not yet read.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One box of a 2-D tensor map (inner coordinate col, outer row) into
// shared memory, completing its bytes on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
        "r"(row)
      : "memory");
}

// ------------------------------------------------------------- host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, looked up once
// (so the library needs no -lcuda).
static inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// A (rows, cols) row-major matrix of `type` (elements of `esize` bytes, a
// row `row_bytes` apart, a multiple of 16) as a 2-D map of boxes of
// box_rows x box_cols; reads past either edge fill zeros and still count
// the whole box's bytes on the barrier.
static inline bool tensor_map_2d(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                                 long long rows, long long cols, long long row_bytes,
                                 int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int MAX_DEVICES = 64;

// Allow Kernel `smem` bytes of dynamic shared memory on the current device.
// The limit belongs to each device's context: it is raised the first time a
// launch on that device needs more than 48 KB, and after that this costs a
// cudaGetDevice, a read of the thread's current device.
template <auto Kernel>
cudaError_t allow_smem(int smem) {
  static int allowed[MAX_DEVICES] = {};  // one for each kernel and device; 0: 48 KB
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < MAX_DEVICES && smem <= allowed[dev])) return e;
  e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && dev < MAX_DEVICES) allowed[dev] = smem;
  return e;
}

// Launch Kernel on clusters of `cluster` blocks along grid.x (grid.x a
// multiple of it), its shared-memory limit raised by allow_smem.
template <auto Kernel, typename... Args>
cudaError_t launch_cluster(dim3 grid, int threads, int smem, int cluster, cudaStream_t stream,
                           Args... args) {
  const cudaError_t e = allow_smem<Kernel>(smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, Kernel, args...);
}

}  // namespace wmt_async
