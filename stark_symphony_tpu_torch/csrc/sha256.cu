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
// memory only for their inputs and outputs.
//
// Layout: one lane (one message, one Merkle path) per thread.  Arrays are
// word-major, (W, lanes): thread i reads word j at j * lanes + i, so the 32
// threads of a warp read 128 consecutive bytes for every word.  The grid is
// ceil(lanes / 256) blocks and the last block masks its ragged edge; there
// is no tile geometry and no lane padding.
//
// Each launcher takes its device and PyTorch's current stream, launches,
// and returns cudaGetLastError() so the Python wrapper can raise on a
// refused launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "sha256.cuh"

namespace stpu {

constexpr int kThreads = 256;

// K1: per lane, SHA-256 of an n-word big-endian message.
__global__ void __launch_bounds__(kThreads)
sha256_words_kernel(const uint32_t* __restrict__ msg, uint32_t* __restrict__ out,
                    int n, int lanes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  uint32_t st[8];
  sha256_strided(msg + i, static_cast<size_t>(lanes), n, st);
#pragma unroll
  for (int k = 0; k < 8; ++k) out[static_cast<size_t>(k) * lanes + i] = st[k];
}

// K2: per lane, the Merkle node hash sha256(left || right).
__global__ void __launch_bounds__(kThreads)
sha256_pair_kernel(const uint32_t* __restrict__ left,
                   const uint32_t* __restrict__ right, uint32_t* __restrict__ out,
                   int lanes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  uint32_t l[8], r[8], h[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    l[k] = left[static_cast<size_t>(k) * lanes + i];
    r[k] = right[static_cast<size_t>(k) * lanes + i];
  }
  node_hash(l, r, h);
#pragma unroll
  for (int k = 0; k < 8; ++k) out[static_cast<size_t>(k) * lanes + i] = h[k];
}

// K3: per lane, walk the authentication path from the leaf digest and return
// the root.  At level lvl the low index bit puts the sibling on the left
// (odd) or on the right (even).  A lane stops at its own true depth: levels
// at or beyond depths[i] leave its digest and its index unchanged, exactly
// as the `active` mask of _walk_tiles does.  sibs is (depth, 8, lanes).
__global__ void __launch_bounds__(kThreads)
merkle_walk_kernel(const uint32_t* __restrict__ leaf,
                   const uint32_t* __restrict__ index,
                   const uint32_t* __restrict__ depths,
                   const uint32_t* __restrict__ sibs, uint32_t* __restrict__ out,
                   int depth, int lanes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  uint32_t cur[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) cur[k] = leaf[static_cast<size_t>(k) * lanes + i];
  uint32_t idx = index[i];
  const uint32_t dep = depths[i];
#pragma unroll 1
  for (int lvl = 0; lvl < depth; ++lvl) {
    if (static_cast<uint32_t>(lvl) < dep) {
      merkle_step(cur, idx, sibs + static_cast<size_t>(lvl) * 8 * lanes + i,
                  static_cast<size_t>(lanes));
      idx >>= 1;
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) out[static_cast<size_t>(k) * lanes + i] = cur[k];
}

inline int blocks_for(int lanes) { return (lanes + kThreads - 1) / kThreads; }

}  // namespace stpu

extern "C" {

int stpu_sha256_words(const void* msg, void* out, int n, int lanes, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  stpu::sha256_words_kernel<<<stpu::blocks_for(lanes), stpu::kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(msg), static_cast<uint32_t*>(out), n, lanes);
  return static_cast<int>(cudaGetLastError());
}

int stpu_sha256_pair(const void* left, const void* right, void* out, int lanes,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  stpu::sha256_pair_kernel<<<stpu::blocks_for(lanes), stpu::kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(left), static_cast<const uint32_t*>(right),
      static_cast<uint32_t*>(out), lanes);
  return static_cast<int>(cudaGetLastError());
}

int stpu_merkle_walk(const void* leaf, const void* index, const void* depths,
                     const void* sibs, void* out, int depth, int lanes, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  stpu::merkle_walk_kernel<<<stpu::blocks_for(lanes), stpu::kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(leaf), static_cast<const uint32_t*>(index),
      static_cast<const uint32_t*>(depths), static_cast<const uint32_t*>(sibs),
      static_cast<uint32_t*>(out), depth, lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
