// SHA-256 kernels for Hopper (sm_90a): K1 message hash, K2 Merkle node hash,
// K3 Merkle authentication-path walk.
//
// Replace the Pallas TPU kernels of stark_symphony_tpu/ops/pallas/sha256_kernel.py:
//   K1 sha256_words_kernel  <- sha256_words_tiled (_sha_words_kernel)
//   K2 sha256_pair_kernel   <- sha256_pair_tiled  (_pair_kernel)
//   K3 merkle_walk_kernel   <- merkle_walk_tiled  (_merkle_kernel, _walk_tiles)
//
// What bounds them: 32-bit integer issue, not bytes.  A compression reads
// about 64 B and writes 32 B but issues some 64 x 20 integer operations, so
// the kernels keep the whole working set in registers and touch device
// memory only for their inputs and outputs.  One lane (one message, one
// Merkle path) runs on one thread.
//
// All three read the verifier's int64 words where they lie, lane-major: K1
// a (lanes, n) message array, K2 (lanes, 8) left and right digests, K3 a
// (lanes, 8) leaf, a (lanes,) index and (lanes, depth, 8) siblings; each
// uses the low 32 bits of an element (the word) and writes its (lanes, 8)
// int64 result, each word in [0, 2^32).  A thread's words are n * 8 bytes
// apart, so instead of reading them from device memory one strided word at
// a time, a block stages its lanes in shared memory with the copy engine
// (tma.cuh):
//   K1: its lanes' messages are one contiguous slab, brought in by one 1-D
//       bulk copy (the odd last word of a ragged block by an ordinary load);
//   K2: each operand by one 2-D tensor-map box of `threads` rows of 64
//       bytes, encoded with the 64-byte swizzle (below); an operand's rows
//       may lie any even number of words (16 bytes) apart, 8 or more, so
//       that the even and odd rows of a Merkle tree level (the prover's
//       build_tree) are read in place;
//   K3: the leaf and index slabs by bulk copies, then the siblings level by
//       level through a two-stage ring, each level a 2-D tensor-map box of
//       `threads` rows of 64 bytes, so that level l + 2 is in flight while
//       level l is hashed.  A block stops at the deepest of its lanes.  A
//       stage is refilled only after every thread has read it and passed a
//       proxy fence and a barrier: without the fence, blocks of 64 and 128
//       threads gave wrong roots on the card (a queued read saw the next
//       level's siblings).
// K1 and K3 write their result back through shared memory, so that its
// int64 stores coalesce; K2 stores it with a tensor-map copy.  The block
// size is the launcher's argument (32 to 128 threads): the wrapper takes
// blocks of 32 at small lane counts, so that the transcript's 4,096 lanes
// still spread over 128 SMs, and for K3 paths of per-lane depths, since a
// block walks to its deepest lane.
//
// K2, the Merkle node hash, is one compression over data and one against
// the constant padding schedule (node_hash): 1,664 integer-pipe
// instructions a lane, so 65,536 lanes need at least 6.5 us of issue on
// 132 SMs against 3.8 us for their 12.6 MB of int64 traffic.  Its rows lie
// 64 bytes apart: in a dense slab the 8 threads of a quarter-warp, each
// loading 16 bytes of its own row, would hit only two groups of banks (a
// 4-way conflict).  The 64-byte swizzle stores row r's 16-byte chunk c at
// chunk c ^ ((r >> 1) & 3), so the 8 loads of a quarter-warp fall on
// distinct banks; a thread picks the chunk by address alone, and its 16
// words keep static register indices (no local memory).  The digests go
// back into the thread's row of the left slab, swizzled the same way, and
// out with one tensor-map store a block (after a proxy fence: the copy
// engine reads what the threads wrote).  Rows past the end of the tensor
// arrive as zeros and are not stored, so the ragged last block needs no
// case.  Measured on an H100 SXM (700 W) at 65,536 lanes: 12.2 us a call
// on the device, 48 registers, no spills; plain per-thread 16-byte loads
// of the same rows took 12.2 us too (chip_k2_staging.py, PERF.md).
//
// Each launcher takes its device and PyTorch's current stream, launches,
// and returns cudaGetLastError() (or the error of its own checks) so the
// Python wrapper can raise on a refused launch.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "sha256.cuh"
#include "tma.cuh"

namespace stpu {

constexpr int kMaxLaneThreads = 128;   // K1-K3 blocks: 32 to 128 threads
constexpr size_t kMaxSmem = 232448;    // opt-in shared memory of one block
constexpr size_t kDefaultSmem = 49152; // above this, the kernel must opt in
constexpr uint32_t kSwizzle64Period = 512;  // bytes after which the 64 B swizzle repeats

// K1: per lane, SHA-256 of an n-word big-endian message.  msg (lanes, n),
// out (lanes, 8), both int64.  Shared memory: the block's message slab of
// threads * max(n, 8) elements (it takes the digests on the way out), then
// one mbarrier.
__global__ void __launch_bounds__(kMaxLaneThreads)
sha256_words_kernel(const uint64_t* __restrict__ msg, uint64_t* __restrict__ out,
                    int n, int lanes) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int threads = blockDim.x, tid = threadIdx.x;
  const int first = blockIdx.x * threads;
  const int count = min(threads, lanes - first);
  uint64_t* slab = reinterpret_cast<uint64_t*>(smem);
  uint64_t* bar = slab + static_cast<size_t>(threads) * max(n, 8);
  const uint64_t* src = msg + static_cast<size_t>(first) * n;
  const uint32_t total = static_cast<uint32_t>(count) * n;  // elements
  const uint32_t bulk = total & ~1u;                       // whole 16 B units

  if (tid == 0) {
    mbar_init(bar, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0 && bulk) {
    mbar_expect_tx(bar, bulk * 8u);
    bulk_g2s(slab, src, bulk * 8u, bar);
  }
  for (uint32_t e = bulk + tid; e < total; e += threads) slab[e] = src[e];
  __syncthreads();
  if (bulk) mbar_wait(bar, 0);

  uint32_t st[8] = {};
  if (tid < count) sha256_lanes(slab + static_cast<size_t>(tid) * n, n, st);
  __syncthreads();  // every message is read: the slab takes the digests
  if (tid < count) {
#pragma unroll
    for (int k = 0; k < 8; ++k) slab[tid * 8 + k] = st[k];
  }
  __syncthreads();
  uint64_t* dst = out + static_cast<size_t>(first) * 8;
  for (int e = tid; e < count * 8; e += threads) dst[e] = slab[e];
}

// K2: per lane, the Merkle node hash sha256(left || right).  The three
// tensor maps see the (lanes, 8) int64 left, right and out as (lanes rows)
// x (8 elements), with the 64-byte swizzle and boxes of `threads` rows;
// out's rows are contiguous, left's and right's lie their own strides
// apart.
// Shared memory: the left and right slabs of threads x 64 B, from an
// address aligned to 512 B (the swizzle's period), then one mbarrier.
__global__ void __launch_bounds__(kMaxLaneThreads)
sha256_pair_kernel(const __grid_constant__ CUtensorMap left_map,
                   const __grid_constant__ CUtensorMap right_map,
                   const __grid_constant__ CUtensorMap out_map) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int threads = blockDim.x, tid = threadIdx.x;
  const int first = blockIdx.x * threads;
  const uint32_t pad = (kSwizzle64Period - (smem_u32(smem) & (kSwizzle64Period - 1))) &
                       (kSwizzle64Period - 1);
  uint64_t* left_s = reinterpret_cast<uint64_t*>(smem + pad);
  uint64_t* right_s = left_s + threads * 8;
  uint64_t* bar = right_s + threads * 8;

  if (tid == 0) {
    mbar_init(bar, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, static_cast<uint32_t>(threads) * 128u);
    tensor_g2s(left_s, &left_map, 0, first, bar);
    tensor_g2s(right_s, &right_map, 0, first, bar);
  }
  mbar_wait(bar, 0);

  // this thread's row as four 16-byte chunks; chunk c lies at c ^ swz
  const int swz = (tid >> 1) & 3;
  ulonglong2* lrow = reinterpret_cast<ulonglong2*>(left_s + tid * 8);
  const ulonglong2* rrow = reinterpret_cast<const ulonglong2*>(right_s + tid * 8);
  uint32_t l[8], r[8], h[8];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const ulonglong2 a = lrow[c ^ swz], b = rrow[c ^ swz];
    l[2 * c] = static_cast<uint32_t>(a.x);
    l[2 * c + 1] = static_cast<uint32_t>(a.y);
    r[2 * c] = static_cast<uint32_t>(b.x);
    r[2 * c + 1] = static_cast<uint32_t>(b.y);
  }
  node_hash(l, r, h);
  // each thread overwrites only its own left row, which only it has read
#pragma unroll
  for (int c = 0; c < 4; ++c) lrow[c ^ swz] = make_ulonglong2(h[2 * c], h[2 * c + 1]);
  fence_proxy_async();
  __syncthreads();  // every row is written: store the box
  if (tid == 0) {
    tensor_s2g(&out_map, 0, first, left_s);
    bulk_commit();
    bulk_wait_read();
  }
}

// K3: per lane, walk the authentication path from the leaf digest and return
// the root.  At level lvl the low index bit puts the sibling on the left
// (odd) or on the right (even).  A lane stops at its own true depth: levels
// at or beyond it leave its digest and its index unchanged, exactly as the
// `active` mask of _walk_tiles does.  The depth of lane i is
// depths[i % period], or `depth` for every lane when depths is null.
//
// sib_map is the 2-D tensor map of the (lanes, depth, 8) siblings seen as
// (lanes rows) x (depth * 8 elements); the box of level lvl for a block is
// its rows at columns [8 lvl, 8 lvl + 8).  Shared memory: the ring's two
// stages of threads x 8 elements, the leaf slab (the roots on the way out),
// the index slab, three mbarriers (leaf and index; stage 0; stage 1) and
// the block's level count.
__global__ void __launch_bounds__(kMaxLaneThreads)
merkle_walk_kernel(const __grid_constant__ CUtensorMap sib_map,
                   const uint64_t* __restrict__ leaf,
                   const uint64_t* __restrict__ index,
                   const int32_t* __restrict__ depths, int period,
                   uint64_t* __restrict__ out, int depth, int lanes) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int threads = blockDim.x, tid = threadIdx.x;
  const int first = blockIdx.x * threads;
  const int count = min(threads, lanes - first);
  const int row = threads * 8;  // elements of one stage
  uint64_t* ring = reinterpret_cast<uint64_t*>(smem);
  uint64_t* leaf_s = ring + 2 * row;
  uint64_t* idx_s = leaf_s + row;
  uint64_t* bars = idx_s + threads;
  int* levels = reinterpret_cast<int*>(bars + 3);

  int dep = 0;
  if (tid < count) {
    dep = depths ? depths[(first + tid) % period] : depth;
    dep = max(0, min(dep, depth));
  }
  if (tid == 0) {
    for (int b = 0; b < 3; ++b) mbar_init(bars + b, 1);
    fence_mbar_init();
    *levels = 0;
  }
  __syncthreads();
  atomicMax(levels, dep);
  if (tid == 0) {
    const uint32_t leaf_bytes = static_cast<uint32_t>(count) * 64u;
    const uint32_t idx_bytes = static_cast<uint32_t>(count & ~1) * 8u;
    mbar_expect_tx(bars, leaf_bytes + idx_bytes);
    bulk_g2s(leaf_s, leaf + static_cast<size_t>(first) * 8, leaf_bytes, bars);
    if (idx_bytes) bulk_g2s(idx_s, index + first, idx_bytes, bars);
  }
  if ((count & 1) && tid == count - 1) idx_s[tid] = index[first + tid];
  __syncthreads();  // the level count is final
  const int n_levels = *levels;
  if (tid == 0) {
    for (int s = 0; s < 2 && s < n_levels; ++s) {
      mbar_expect_tx(bars + 1 + s, static_cast<uint32_t>(row) * 8u);
      tensor_g2s(ring + s * row, &sib_map, 8 * s, first, bars + 1 + s);
    }
  }

  mbar_wait(bars, 0);
  uint32_t cur[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) cur[k] = static_cast<uint32_t>(leaf_s[tid * 8 + k]);
  uint32_t idx = static_cast<uint32_t>(idx_s[tid]);
#pragma unroll 1
  for (int lvl = 0; lvl < n_levels; ++lvl) {
    const int s = lvl & 1;
    uint64_t* stage = ring + s * row;
    mbar_wait(bars + 1 + s, (lvl >> 1) & 1);
    uint32_t sib[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) sib[k] = static_cast<uint32_t>(stage[tid * 8 + k]);
    fence_proxy_async();
    __syncthreads();  // the stage is read: refill it with level lvl + 2
    if (tid == 0 && lvl + 2 < n_levels) {
      mbar_expect_tx(bars + 1 + s, static_cast<uint32_t>(row) * 8u);
      tensor_g2s(stage, &sib_map, 8 * (lvl + 2), first, bars + 1 + s);
    }
    if (lvl < dep) {
      merkle_node(cur, idx, sib);
      idx >>= 1;
    }
  }

  // each thread overwrites only its own leaf row, which only it has read
  if (tid < count) {
#pragma unroll
    for (int k = 0; k < 8; ++k) leaf_s[tid * 8 + k] = cur[k];
  }
  __syncthreads();
  uint64_t* dst = out + static_cast<size_t>(first) * 8;
  for (int e = tid; e < count * 8; e += threads) dst[e] = leaf_s[e];
}

inline bool lane_threads_ok(int threads) {
  return threads >= 32 && threads <= kMaxLaneThreads && threads % 32 == 0;
}

inline size_t words_smem(int n, int threads) {
  return static_cast<size_t>(threads) * (n > 8 ? n : 8) * 8 + 8;
}

inline size_t pair_smem(int threads) {
  // up to one swizzle period of alignment, two slabs of 64 B a lane, the
  // barrier
  return kSwizzle64Period + static_cast<size_t>(threads) * 128 + 8;
}

inline size_t walk_smem(int threads) {
  // two stages and the leaf slab of 64 B a lane, the index slab of 8 B a
  // lane, three barriers, the level count (padded to 8 B)
  return static_cast<size_t>(threads) * (3 * 64 + 8) + 4 * 8;
}

// cuTensorMapEncodeTiled, fetched from libcuda through the runtime, so the
// library needs no link against it.
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
    }
  }
  return fn;
}

}  // namespace stpu

extern "C" {

// Launchers return this for arguments their kernels do not take, and
// kEncodeFailed + the CUresult when a tensor map is refused.
constexpr int kBadArgument = static_cast<int>(cudaErrorInvalidValue);
constexpr int kEncodeFailed = 100000;

int stpu_sha256_words(const void* msg, void* out, int n, int lanes, int threads,
                      int device, void* stream) {
  if (n < 1 || lanes < 1 || !stpu::lane_threads_ok(threads)) return kBadArgument;
  const size_t smem = stpu::words_smem(n, threads);
  if (smem > stpu::kMaxSmem) return kBadArgument;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > stpu::kDefaultSmem) {
    err = cudaFuncSetAttribute(stpu::sha256_words_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (lanes + threads - 1) / threads;
  stpu::sha256_words_kernel<<<blocks, threads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(msg), static_cast<uint64_t*>(out), n, lanes);
  return static_cast<int>(cudaGetLastError());
}

// left_stride and right_stride: elements from one row of the operand to the
// next (8 where its rows are contiguous; even, for 16-byte strides).
int stpu_sha256_pair(const void* left, const void* right, void* out, int lanes,
                     int threads, int left_stride, int right_stride, int device,
                     void* stream) {
  if (lanes < 1 || !stpu::lane_threads_ok(threads) || left_stride < 8 ||
      right_stride < 8 || (left_stride | right_stride) & 1) {
    return kBadArgument;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  PFN_cuTensorMapEncodeTiled_v12000 encode = stpu::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const void* ptrs[3] = {left, right, out};
  const int row_strides[3] = {left_stride, right_stride, 8};
  CUtensorMap maps[3];
  const cuuint64_t dims[2] = {8u, static_cast<cuuint64_t>(lanes)};
  const cuuint32_t box[2] = {8u, static_cast<cuuint32_t>(threads)};
  const cuuint32_t elem_strides[2] = {1u, 1u};
  for (int m = 0; m < 3; ++m) {
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_strides[m]) *
                                   sizeof(uint64_t)};
    const CUresult res = encode(
        &maps[m], CU_TENSOR_MAP_DATA_TYPE_UINT64, 2, const_cast<void*>(ptrs[m]), dims,
        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return kEncodeFailed + static_cast<int>(res);
  }
  const int blocks = (lanes + threads - 1) / threads;
  stpu::sha256_pair_kernel<<<blocks, threads, stpu::pair_smem(threads),
                             static_cast<cudaStream_t>(stream)>>>(maps[0], maps[1],
                                                                  maps[2]);
  return static_cast<int>(cudaGetLastError());
}

int stpu_merkle_walk(const void* leaf, const void* index, const void* depths,
                     int period, const void* sibs, void* out, int depth, int lanes,
                     int threads, int device, void* stream) {
  if (depth < 0 || lanes < 1 || !stpu::lane_threads_ok(threads) ||
      (depths != nullptr && period < 1)) {
    return kBadArgument;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map;
  std::memset(&map, 0, sizeof(map));
  if (depth > 0) {
    PFN_cuTensorMapEncodeTiled_v12000 encode = stpu::encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t dims[2] = {8ull * depth, static_cast<cuuint64_t>(lanes)};
    const cuuint64_t strides[1] = {8ull * depth * sizeof(uint64_t)};
    const cuuint32_t box[2] = {8u, static_cast<cuuint32_t>(threads)};
    const cuuint32_t elem_strides[2] = {1u, 1u};
    const CUresult res = encode(
        &map, CU_TENSOR_MAP_DATA_TYPE_UINT64, 2, const_cast<void*>(sibs), dims,
        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return kEncodeFailed + static_cast<int>(res);
  }
  const int blocks = (lanes + threads - 1) / threads;
  stpu::merkle_walk_kernel<<<blocks, threads, stpu::walk_smem(threads),
                             static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const uint64_t*>(leaf), static_cast<const uint64_t*>(index),
      static_cast<const int32_t*>(depths), period, static_cast<uint64_t*>(out),
      depth, lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
