// M31 / QM31 device arithmetic for the FRI kernel in fri.cu and the DEEP
// quotient kernel in deep.cu.
//
// Counterpart of the field helpers of stark_symphony_tpu/ops/pallas/fri_kernel.py:
//   _m31_red / _m31_add / _m31_neg / _m31_sub / _m31_mul -> m31_red ... m31_mul
//   _cm31_mul                                            -> cm31_mul
//   _qm31_add / _qm31_sub / _qm31_mul / _qm31_mul_m31    -> qm31_add ... qm31_mul_m31
// and, at the end of the file, of the helpers of ops/field.py that the Pallas
// kernel has no counterpart of (m31_sqr, m31_inv, cm31_inv, qm31_mul_cm31).
// The helpers above are the same formulas as ops/field.py's of the same
// name, step for step: its qm31_mul forms (2 + i) * ai * bi through cm31_mul
// with the constant (2, 1), and since cm31_mul's outputs are canonical that
// gives the words of the add chain below on any operand.
//
// Every function is bit-identical to the JAX formulas on ANY 32-bit word,
// not only on canonical values below P: tampered proofs carry words >= P.
// So the sum in m31_add wraps at 2^32 as the uint32 sum does, m31_neg wraps
// for a > P, and m31_mul folds the 64-bit product exactly as the JAX limb
// code does: low31 = lo & P, high = (hi << 1) | (lo >> 31) with hi's top bit
// dropped, then m31_red(low31 + high) with the sum wrapping at 2^32.  (A
// `% P` of the 64-bit product would differ from it for words >= 2^31.)  The
// product itself is the one 32x32 -> 64-bit multiply, where the TPU code
// needed four 16-bit limb products.
//
// A QM31 value is 4 words [a, b, c, d] = (a + b i) + (c + d i) j, with
// i^2 = -1 and j^2 = 2 + i.
#pragma once

#include <cstdint>

namespace stpu {

constexpr uint32_t kP = 0x7FFFFFFFu;  // 2^31 - 1

__device__ __forceinline__ uint32_t m31_red(uint32_t x) {
  x = (x & kP) + (x >> 31);
  return x >= kP ? x - kP : x;
}

__device__ __forceinline__ uint32_t m31_add(uint32_t a, uint32_t b) {
  return m31_red(a + b);
}

__device__ __forceinline__ uint32_t m31_neg(uint32_t a) {
  return a == 0u ? 0u : kP - a;
}

__device__ __forceinline__ uint32_t m31_sub(uint32_t a, uint32_t b) {
  return m31_add(a, m31_neg(b));
}

__device__ __forceinline__ uint32_t m31_mul(uint32_t a, uint32_t b) {
  const uint64_t p = static_cast<uint64_t>(a) * b;
  const uint32_t lo = static_cast<uint32_t>(p);
  const uint32_t hi = static_cast<uint32_t>(p >> 32);
  const uint32_t low31 = lo & kP;
  const uint32_t high = (hi << 1) | (lo >> 31);
  return m31_red(low31 + high);
}

// (ar + ai i)(br + bi i) -> (re, im)
__device__ __forceinline__ void cm31_mul(uint32_t ar, uint32_t ai, uint32_t br,
                                         uint32_t bi, uint32_t& re, uint32_t& im) {
  re = m31_sub(m31_mul(ar, br), m31_mul(ai, bi));
  im = m31_add(m31_mul(ar, bi), m31_mul(ai, br));
}

__device__ __forceinline__ void qm31_add(const uint32_t a[4], const uint32_t b[4],
                                         uint32_t out[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = m31_add(a[k], b[k]);
}

__device__ __forceinline__ void qm31_sub(const uint32_t a[4], const uint32_t b[4],
                                         uint32_t out[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = m31_sub(a[k], b[k]);
}

__device__ __forceinline__ void qm31_mul_m31(const uint32_t a[4], uint32_t s,
                                             uint32_t out[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = m31_mul(a[k], s);
}

// (ar + ai j)(br + bi j) = (ar br + (2 + i) ai bi) + (ar bi + ai br) j,
// term for term as _qm31_mul computes it.
__device__ __forceinline__ void qm31_mul(const uint32_t a[4], const uint32_t b[4],
                                         uint32_t out[4]) {
  uint32_t rr, ri, pr, pi, ir, ii, jr, ji;
  cm31_mul(a[0], a[1], b[0], b[1], rr, ri);
  cm31_mul(a[2], a[3], b[2], b[3], pr, pi);
  // (2 + i)(pr + pi i) = (2 pr - pi) + (pr + 2 pi) i
  const uint32_t tr = m31_sub(m31_add(pr, pr), pi);
  const uint32_t ti = m31_add(pr, m31_add(pi, pi));
  cm31_mul(a[0], a[1], b[2], b[3], ir, ii);
  cm31_mul(a[2], a[3], b[0], b[1], jr, ji);
  out[0] = m31_add(rr, tr);
  out[1] = m31_add(ri, ti);
  out[2] = m31_add(ir, jr);
  out[3] = m31_add(ii, ji);
}

// ops/field.py m31_sqr.
__device__ __forceinline__ uint32_t m31_sqr(uint32_t a) { return m31_mul(a, a); }

// x^(2^k): k squarings, as ops/field.py m31_pow takes a power of two.
__device__ __forceinline__ uint32_t m31_sqr_n(uint32_t x, int k) {
#pragma unroll 1
  for (int s = 0; s < k; ++s) x = m31_sqr(x);
  return x;
}

// ops/field.py m31_inv: a^(p - 2) by its 37-multiplication addition chain,
// product for product; inv(0) = 0.
__device__ __forceinline__ uint32_t m31_inv(uint32_t a) {
  const uint32_t t0 = m31_mul(m31_sqr_n(a, 2), a);    // a^5
  const uint32_t t1 = m31_mul(m31_sqr(t0), t0);       // a^15
  const uint32_t t2 = m31_mul(m31_sqr_n(t1, 3), t0);  // a^125
  const uint32_t t3 = m31_mul(m31_sqr(t2), t0);       // a^255
  const uint32_t t4 = m31_mul(m31_sqr_n(t3, 8), t3);  // a^65535
  const uint32_t t5 = m31_mul(m31_sqr_n(t4, 8), t3);  // a^16777215
  return m31_mul(m31_sqr_n(t5, 7), t2);               // a^2147483645
}

// ops/field.py cm31_inv: conj(a) * inv(ar^2 + ai^2).
__device__ __forceinline__ void cm31_inv(uint32_t ar, uint32_t ai, uint32_t& re,
                                         uint32_t& im) {
  const uint32_t ninv = m31_inv(m31_add(m31_sqr(ar), m31_sqr(ai)));
  re = m31_mul(ar, ninv);
  im = m31_mul(m31_neg(ai), ninv);
}

// ops/field.py qm31_mul_cm31: both CM31 coordinates of a times (cr + ci i).
__device__ __forceinline__ void qm31_mul_cm31(const uint32_t a[4], uint32_t cr,
                                              uint32_t ci, uint32_t out[4]) {
  cm31_mul(a[0], a[1], cr, ci, out[0], out[1]);
  cm31_mul(a[2], a[3], cr, ci, out[2], out[3]);
}

}  // namespace stpu
