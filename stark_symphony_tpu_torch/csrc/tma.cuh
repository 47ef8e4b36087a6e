// Hopper's asynchronous copies between device and shared memory, and the
// mbarriers that report the completion of those into shared memory (sm_90).
// Used by the K1, K2 and K3 kernels of sha256.cu to stage their lane-major
// int64 inputs, and by K2 to store its result.
//
// A copy is issued by one thread: it arms the stage's mbarrier with the
// bytes to expect (mbar_expect_tx), then issues the copy, which the copy
// engine completes against that barrier.  Every thread that reads the
// stage waits for the barrier's phase to flip (mbar_wait).  A barrier that
// has completed k times is waited for with parity k & 1.
//
// The copies need 16-byte-aligned addresses and, for the 1-D bulk copy, a
// size that is a multiple of 16 bytes; the callers hold to that.  A box
// copied with a swizzle lands at a shared address aligned to the swizzle's
// period (512 B for CU_TENSOR_MAP_SWIZZLE_64B), so that its pattern depends
// on the row alone.
#pragma once

#include <cuda.h>

#include <cstdint>

namespace stpu {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One barrier expecting `count` arrivals.  Call from one thread, then
// fence_mbar_init() and __syncthreads() before any thread uses it.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive on `bar` and add `bytes` to the transfers it waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's current phase is no longer `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Orders this thread's earlier shared-memory accesses (generic proxy)
// before the copies (async proxy) that follow a __syncthreads(), in both
// directions:
//   - a buffer that threads have read is refilled by a copy into shared
//     memory only after every reader has passed this fence and the
//     barrier: otherwise a read still queued may see the new data;
//   - a buffer that threads have written is stored by a copy out of shared
//     memory (tensor_s2g) only after every writer has passed this fence and
//     the barrier: otherwise the copy may read the old data.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 1-D bulk copy of `bytes` contiguous bytes from device memory to shared
// memory, completing against `bar`.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 2-D tensor-map copy of the box at coordinates (c0 innermost, c1) into
// shared memory, completing against `bar`.  Rows of the box that fall
// outside the tensor arrive as zeros and still count their bytes.
__device__ __forceinline__ void tensor_g2s(void* dst, const CUtensorMap* map,
                                           int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// 2-D tensor-map store of the box at coordinates (c0 innermost, c1) from
// shared memory to device memory, in the issuing thread's bulk group (see
// fence_proxy_async for what must come before it).  Rows of the box that
// fall outside the tensor are not written.  The copy reads the shared
// memory after the instruction returns: the issuing thread commits the
// group and waits for it (bulk_commit, bulk_wait_read) before the buffer
// is written again or the block exits.
__device__ __forceinline__ void tensor_s2g(const CUtensorMap* map, int c0, int c1,
                                           const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group "
      "[%0, {%1, %2}], [%3];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(smem_u32(src))
      : "memory");
}

// Close the issuing thread's bulk group of stores.
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until every committed store of this thread has read its shared
// memory (its writes to device memory may still be in flight; they are
// visible to the kernels that follow).
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

}  // namespace stpu
