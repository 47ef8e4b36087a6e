// K6: stage VI of the stwo verifier, the DEEP quotients of every (proof,
// query) lane, for Hopper (sm_90a).
//
// It replaces no Pallas kernel: the JAX package leaves stage VI
// (stark_symphony_tpu/models/stwo/verifier.py fri_answers) to XLA's fusion
// of its jnp field code.  On the card the same code ran as chains of eager
// int64 elementwise kernels, each reading and writing whole tensors; here
// each lane's whole sum stays in registers.
//
// What bounds it: 32-bit integer throughput.  A lane reads 2 + C + K words and
// writes 4, against some 250 M31 multiplies (the denominator's inverse, two
// multiplies by M31 a sample, the closing products), and a proof adds some
// 1,900 (each sample's interpolant (a, b, c) and its power of alpha).
//
// Design: one thread per lane, lane = b * Q + q, so a proof's lanes are
// adjacent and its per-proof words are broadcast reads.  Per lane: the CM31
// denominator and its inverse, then for each of the C trace columns and K
// composition partitions, in that order, the interpolant (a, b, c) scaled by
// alpha^i and b * v - (a * y_q + c) added into a QM31 accumulator, then
// acc * denom_inv * alpha^(C + K), all in registers.  The per-proof part
// (each sample's scaled (a, b, c) and alpha^(C + K)) is computed once a
// proof into shared memory by the block's threads, not once a lane: at
// 4,096 proofs x 16 queries that took 0.054-0.073 ms a call against
// 0.094 ms for the lane that computes its own (H100, both bit-equal).
// Nothing intermediate goes to device memory.
//
// Bit for bit with ops/field.py on any 32-bit word, non-canonical ones
// (>= P, >= 2^31) included, as tampered proofs carry them: the formulas of
// m31.cuh, in the order verifier.fri_answers_plain applies them (its
// deep_denominator_inverse and deep_interpolant_coefficients term for
// term).  Inputs are the verifier's int64 words, read in place, lane-major;
// the low 32 bits of each are the word.

#include <cuda_runtime.h>

#include <cstdint>

#include "m31.cuh"

namespace stpu {

constexpr int kDeepThreads = 256;
constexpr int kDeepSmem = 48 * 1024;  // without the opt-in to more

__device__ __forceinline__ void load4(const uint64_t* __restrict__ p, uint32_t v[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = static_cast<uint32_t>(p[k]);
}

__device__ __forceinline__ void copy4(const uint32_t a[4], uint32_t out[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = a[k];
}

// verifier.deep_denominator_inverse at one query point (x, y):
// inv((prx - x, prx_i) * piy - (pry - y, pry_i) * pix), as CM31.
__device__ __forceinline__ void denominator_inverse(const uint32_t px[4],
                                                    const uint32_t py[4], uint32_t x,
                                                    uint32_t y, uint32_t& re,
                                                    uint32_t& im) {
  uint32_t ur, ui, vr, vi;
  cm31_mul(m31_sub(px[0], x), px[1], py[2], py[3], ur, ui);
  cm31_mul(m31_sub(py[0], y), py[1], px[2], px[3], vr, vi);
  cm31_inv(m31_sub(ur, vr), m31_sub(ui, vi), re, im);
}

// verifier.deep_interpolant_coefficients of one sample value v at the OODS
// point's y: a = (0, -2 im v), b = (0, -2 im py), c = b v - a py, each
// times alpha^i.
__device__ __forceinline__ void interpolant(const uint32_t py[4], const uint32_t v[4],
                                            const uint32_t alpha[4], uint32_t a_s[4],
                                            uint32_t b_s[4], uint32_t c_s[4]) {
  const uint32_t a[4] = {0u, 0u, m31_neg(m31_add(v[2], v[2])),
                         m31_neg(m31_add(v[3], v[3]))};
  const uint32_t b[4] = {0u, 0u, m31_neg(m31_add(py[2], py[2])),
                         m31_neg(m31_add(py[3], py[3]))};
  uint32_t bv[4], apy[4], c[4];
  qm31_mul(b, v, bv);
  qm31_mul(a, py, apy);
  qm31_sub(bv, apy, c);
  qm31_mul(alpha, a, a_s);
  qm31_mul(alpha, b, b_s);
  qm31_mul(alpha, c, c_s);
}

// acc += b * val - (a * y + c)
__device__ __forceinline__ void accumulate(uint32_t acc[4], const uint32_t a[4],
                                           const uint32_t b[4], const uint32_t c[4],
                                           uint32_t val, uint32_t y) {
  uint32_t bv[4], ay[4], t[4], num[4], sum[4];
  qm31_mul_m31(b, val, bv);
  qm31_mul_m31(a, y, ay);
  qm31_add(ay, c, t);
  qm31_sub(bv, t, num);
  qm31_add(acc, num, sum);
  copy4(sum, acc);
}

// A block takes whole proofs, `per_block` of them, lanes p0 * Q onwards.
// First its threads compute each (proof, sample)'s scaled interpolant
// (a, b, c), 12 words, and each proof's alpha^(C + K), 4 words, into shared
// memory: a thread a job, alpha^i by i products from alpha in the order of
// verifier's chain.  Then each lane sums over its proof's samples.
// pts (lanes, 2), trace (lanes, C), cp (lanes, K); per proof alpha (B, 4),
// point (B, 2, 4), oods_trace (B, C, 4), oods_cp (B, K, 4) -> out (lanes, 4).
__global__ void __launch_bounds__(kDeepThreads)
deep_quotients_kernel(const uint64_t* __restrict__ pts,
                      const uint64_t* __restrict__ trace,
                      const uint64_t* __restrict__ cp,
                      const uint64_t* __restrict__ alpha,
                      const uint64_t* __restrict__ point,
                      const uint64_t* __restrict__ oods_trace,
                      const uint64_t* __restrict__ oods_cp,
                      uint64_t* __restrict__ out, int n_cols, int n_parts,
                      int n_queries, int n_proofs, int per_block) {
  extern __shared__ uint32_t coef[];
  const int n = n_cols + n_parts;
  const int stride = 12 * n + 4;
  const int p0 = blockIdx.x * per_block;
  const int np = min(per_block, n_proofs - p0);
  for (int j = threadIdx.x; j < np * (n + 1); j += blockDim.x) {
    const int p = j / (n + 1), k = j % (n + 1);
    const size_t b = static_cast<size_t>(p0 + p);
    uint32_t rc[4], ai[4], next[4];
    load4(alpha + b * 4, rc);
    copy4(rc, ai);
#pragma unroll 1
    for (int s = 0; s < k; ++s) {
      qm31_mul(ai, rc, next);
      copy4(next, ai);
    }
    uint32_t* dst = coef + p * stride + 12 * k;
    if (k == n) {
      copy4(ai, dst);
      continue;
    }
    const uint64_t* sample = k < n_cols ? oods_trace + (b * n_cols + k) * 4
                                        : oods_cp + (b * n_parts + (k - n_cols)) * 4;
    uint32_t py[4], v[4], a[4], bb[4], c[4];
    load4(point + b * 8 + 4, py);
    load4(sample, v);
    interpolant(py, v, ai, a, bb, c);
    copy4(a, dst);
    copy4(bb, dst + 4);
    copy4(c, dst + 8);
  }
  __syncthreads();
  for (int l = threadIdx.x; l < np * n_queries; l += blockDim.x) {
    const int p = l / n_queries;
    const size_t b = static_cast<size_t>(p0 + p);
    const size_t i = static_cast<size_t>(p0) * n_queries + l;
    uint32_t px[4], py[4];
    load4(point + b * 8, px);
    load4(point + b * 8 + 4, py);
    const uint32_t y = static_cast<uint32_t>(pts[2 * i + 1]);
    uint32_t dr, di;
    denominator_inverse(px, py, static_cast<uint32_t>(pts[2 * i]), y, dr, di);
    const uint32_t* cf = coef + p * stride;
    uint32_t acc[4] = {0u, 0u, 0u, 0u};
#pragma unroll 1
    for (int k = 0; k < n; ++k) {
      const uint32_t val = static_cast<uint32_t>(
          k < n_cols ? trace[i * n_cols + k] : cp[i * n_parts + (k - n_cols)]);
      accumulate(acc, cf + 12 * k, cf + 12 * k + 4, cf + 12 * k + 8, val, y);
    }
    uint32_t t[4], res[4];
    qm31_mul_cm31(acc, dr, di, t);
    qm31_mul(t, cf + 12 * n, res);
    uint64_t* dst = out + i * 4;
#pragma unroll
    for (int k = 0; k < 4; ++k) dst[k] = res[k];
  }
}

// Shared bytes of one proof's coefficients, and the proofs a block takes:
// kDeepThreads lanes' worth, at least one, as many as fit kDeepSmem (0 if
// not even one does).
inline int deep_proof_bytes(int samples) { return (12 * samples + 4) * 4; }

inline int deep_proofs_per_block(int samples, int n_queries) {
  const int fit = kDeepSmem / deep_proof_bytes(samples);
  const int want = kDeepThreads / n_queries > 1 ? kDeepThreads / n_queries : 1;
  return want < fit ? want : fit;
}

}  // namespace stpu

extern "C" {

int stpu_deep_quotients(const void* pts, const void* trace, const void* cp,
                        const void* alpha, const void* point, const void* oods_trace,
                        const void* oods_cp, void* out, int n_cols, int n_parts,
                        int n_queries, int lanes, int device, void* stream) {
  if (n_cols < 0 || n_parts < 0 || n_queries < 1 || lanes < 0 || lanes % n_queries) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per_block = stpu::deep_proofs_per_block(n_cols + n_parts, n_queries);
  if (per_block < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (lanes == 0) return 0;
  const int n_proofs = lanes / n_queries;
  const int lanes_a_block = per_block * n_queries;
  const int threads = lanes_a_block < stpu::kDeepThreads ? lanes_a_block : stpu::kDeepThreads;
  stpu::deep_quotients_kernel<<<(n_proofs + per_block - 1) / per_block, threads,
                                per_block * stpu::deep_proof_bytes(n_cols + n_parts),
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(pts), static_cast<const uint64_t*>(trace),
      static_cast<const uint64_t*>(cp), static_cast<const uint64_t*>(alpha),
      static_cast<const uint64_t*>(point), static_cast<const uint64_t*>(oods_trace),
      static_cast<const uint64_t*>(oods_cp), static_cast<uint64_t*>(out), n_cols,
      n_parts, n_queries, n_proofs, per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
