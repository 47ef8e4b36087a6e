// Fused verifier-stage kernels for Hopper (sm_90a): K4 stage-V leaf hash +
// Merkle walk + root compare, K5 all FRI layers of stage VII.
//
// Replace the Pallas TPU kernels of stark_symphony_tpu/ops/pallas/fri_kernel.py:
//   K4 leafwalk_kernel  <- leafwalk_tiled       (_leafwalk_kernel)
//   K5 fri_kernel       <- fri_all_layers_tiled (_fri_kernel)
//
// What bounds them: 32-bit integer issue, as for the kernels of sha256.cu.
// A lane of K4 runs 27 (trace, 4 words) or 28 (composition, 16 words)
// compressions at depth 13 and a lane of K5 180 at PRODUCTION (per layer two
// 4-word leaves, the node hash and the walk), some 1,400 integer instructions
// each, against about 1 byte read per 100 instructions.  So every
// intermediate (leaf digests, walk state, the QM31 fold value, the query)
// stays in registers from the first layer to the last, and device memory
// sees only the inputs, read once, and the outputs.
//
// Layout: one (proof, query) lane per thread, lane = b * Q + q.  Per-lane
// arrays are word-major, (W, lanes), so a warp's 32 threads read 128
// consecutive bytes for every word.  Per-proof operands (the Merkle roots,
// the FRI alphas) are read from (B, ...) arrays at b = lane / Q, where the
// TPU kernel needed them broadcast to every lane.  The grid is ceil(lanes / 256)
// blocks and the last block masks its ragged edge.
//
// The layer and level loops are not unrolled (`#pragma unroll 1`): each node
// hash is some 1,400 instructions, and 72 of them inlined would multiply
// code size and build time for no gain in issue rate.

#include <cuda_runtime.h>

#include <cstdint>

#include "m31.cuh"
#include "sha256.cuh"

namespace stpu {

constexpr int kFriThreads = 256;
constexpr int kMaxLayers = 32;  // a domain of at most 2^31 points

// Per-layer Merkle depths, passed by value in the kernel's parameters.
struct LayerDepths {
  int d[kMaxLayers];
};

// SHA-256 of a 4-word message: one block, padding constant.
__device__ __forceinline__ void sha256_4words(const uint32_t m[4], uint32_t st[8]) {
  uint32_t w[16];
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = m[k];
  w[4] = 0x80000000u;
#pragma unroll
  for (int k = 5; k < 15; ++k) w[k] = 0u;
  w[15] = 128u;  // bit length
  set_iv(st);
  compress(st, w);
}

__device__ __forceinline__ uint32_t digest_eq(const uint32_t a[8],
                                              const uint32_t* __restrict__ b) {
  bool ok = true;
#pragma unroll
  for (int k = 0; k < 8; ++k) ok &= a[k] == b[k];
  return ok ? 1u : 0u;
}

inline int fri_blocks(int lanes) { return (lanes + kFriThreads - 1) / kFriThreads; }

// K4: per lane, hash the n_words column evals into the leaf digest, walk the
// depth-level authentication path, and compare with the proof's root.
// evals (n_words, lanes), index (lanes), sibs (depth, 8, lanes),
// roots (B, 8) with B = lanes / n_queries -> ok (lanes) in {0, 1}.
__global__ void __launch_bounds__(kFriThreads)
leafwalk_kernel(const uint32_t* __restrict__ evals,
                const uint32_t* __restrict__ index,
                const uint32_t* __restrict__ sibs,
                const uint32_t* __restrict__ roots, uint32_t* __restrict__ ok,
                int n_words, int depth, int n_queries, int lanes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  const size_t stride = static_cast<size_t>(lanes);
  uint32_t cur[8];
  sha256_strided(evals + i, stride, n_words, cur);
  uint32_t idx = index[i];
#pragma unroll 1
  for (int lvl = 0; lvl < depth; ++lvl) {
    merkle_step(cur, idx, sibs + static_cast<size_t>(lvl) * 8 * stride + i, stride);
    idx >>= 1;
  }
  ok[i] = digest_eq(cur, roots + static_cast<size_t>(i / n_queries) * 8);
}

// K5: per lane, every FRI layer l in turn: order (eval, witness) by the
// query's parity, hash both 4-word leaves and pair-hash them into the node,
// walk the layer's path (depth d[l], node index q >> 1) and compare with the
// layer's root -> ok[l]; fold e <- (e0 + e1) + alpha_l * ((e0 - e1) * cinv_l)
// in QM31; q <- q >> 1.
// queries (lanes), evals (4, lanes), wits (L, 4, lanes), cinvs (L, lanes),
// alphas (B, L, 4), sibs (sum d, 8, lanes) layer after layer, roots (B, L, 8)
// -> ok (L, lanes), folded (4, lanes), q_out (lanes).
__global__ void __launch_bounds__(kFriThreads)
fri_kernel(const uint32_t* __restrict__ queries,
           const uint32_t* __restrict__ evals, const uint32_t* __restrict__ wits,
           const uint32_t* __restrict__ cinvs,
           const uint32_t* __restrict__ alphas,
           const uint32_t* __restrict__ sibs, const uint32_t* __restrict__ roots,
           uint32_t* __restrict__ ok, uint32_t* __restrict__ folded,
           uint32_t* __restrict__ q_out, const LayerDepths depths, int n_layers,
           int n_queries, int lanes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  const size_t stride = static_cast<size_t>(lanes);
  const size_t proof = static_cast<size_t>(i / n_queries);
  uint32_t q = queries[i];
  uint32_t e[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) e[k] = evals[k * stride + i];
  size_t off = 0;  // first sibling level of the layer
#pragma unroll 1
  for (int l = 0; l < n_layers; ++l) {
    uint32_t e0[4], e1[4];
    const bool odd = (q & 1u) != 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t w = wits[(static_cast<size_t>(l) * 4 + k) * stride + i];
      e0[k] = odd ? w : e[k];
      e1[k] = odd ? e[k] : w;
    }
    uint32_t leaf0[8], leaf1[8], cur[8];
    sha256_4words(e0, leaf0);
    sha256_4words(e1, leaf1);
    node_hash(leaf0, leaf1, cur);
    uint32_t idx = q >> 1;
    const int d = depths.d[l];
#pragma unroll 1
    for (int lvl = 0; lvl < d; ++lvl) {
      merkle_step(cur, idx, sibs + (off + lvl) * 8 * stride + i, stride);
      idx >>= 1;
    }
    const size_t pl = proof * n_layers + l;
    ok[static_cast<size_t>(l) * stride + i] = digest_eq(cur, roots + pl * 8);

    uint32_t f0[4], diff[4], f1[4], af1[4], alpha[4];
    qm31_add(e0, e1, f0);
    qm31_sub(e0, e1, diff);
    qm31_mul_m31(diff, cinvs[static_cast<size_t>(l) * stride + i], f1);
#pragma unroll
    for (int k = 0; k < 4; ++k) alpha[k] = alphas[pl * 4 + k];
    qm31_mul(alpha, f1, af1);
    qm31_add(f0, af1, e);
    q >>= 1;
    off += d;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) folded[k * stride + i] = e[k];
  q_out[i] = q;
}

}  // namespace stpu

extern "C" {

int stpu_leafwalk(const void* evals, const void* index, const void* sibs,
                  const void* roots, void* ok, int n_words, int depth,
                  int n_queries, int lanes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  stpu::leafwalk_kernel<<<stpu::fri_blocks(lanes), stpu::kFriThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(evals), static_cast<const uint32_t*>(index),
      static_cast<const uint32_t*>(sibs), static_cast<const uint32_t*>(roots),
      static_cast<uint32_t*>(ok), n_words, depth, n_queries, lanes);
  return static_cast<int>(cudaGetLastError());
}

// depths: host array of n_layers ints, copied into the kernel's parameters.
int stpu_fri_all_layers(const void* queries, const void* evals, const void* wits,
                        const void* cinvs, const void* alphas, const void* sibs,
                        const void* roots, void* ok, void* folded, void* q_out,
                        const void* depths, int n_layers, int n_queries,
                        int lanes, int device, void* stream) {
  if (n_layers < 0 || n_layers > stpu::kMaxLayers) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  stpu::LayerDepths d{};
  for (int l = 0; l < n_layers; ++l) d.d[l] = static_cast<const int*>(depths)[l];
  stpu::fri_kernel<<<stpu::fri_blocks(lanes), stpu::kFriThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(queries), static_cast<const uint32_t*>(evals),
      static_cast<const uint32_t*>(wits), static_cast<const uint32_t*>(cinvs),
      static_cast<const uint32_t*>(alphas), static_cast<const uint32_t*>(sibs),
      static_cast<const uint32_t*>(roots), static_cast<uint32_t*>(ok),
      static_cast<uint32_t*>(folded), static_cast<uint32_t*>(q_out), d, n_layers,
      n_queries, lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
