// SHA-256 device code shared by the kernels in sha256.cu and fri.cu.
//
// Counterpart of the tile math in stark_symphony_tpu/ops/pallas/sha256_kernel.py:
//   _rounds / _bsig* / _ssig*      -> sha_round, bsig0/1, ssig0/1
//   _sched_window                  -> the rolling 16-word schedule in compress()
//   _compress_tiles                -> compress()
//   _compress_tiles_const          -> compress_pad64() against kPad64Sched
//   _PAD64_SCHED                   -> kPad64Sched
//   _node_tiles                    -> node_hash()
//   _sha_words_tiles               -> sha256_message(), read word-major by
//                                     sha256_strided() (K4, K5) and
//                                     lane-major by sha256_lanes() (K1)
//   one level of _walk_tiles       -> merkle_node(), read word-major by
//                                     merkle_step() (K4, K5)
//
// Every value here is one lane's: a thread hashes its own message, with its
// working state and its 16-word schedule window in registers (the loops are
// fully unrolled, so every array index is static).
//
// The tables are `static`: every .cu that includes this header gets its own
// copy, so the translation units of one library do not clash at link time.
#pragma once

#include <cstddef>
#include <cstdint>

namespace stpu {

static __constant__ uint32_t kK[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
    0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u,
    0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu,
    0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu, 0x53380D13u,
    0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,
    0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u,
    0x19A4C116u, 0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au,
    0x5B9CCA4Fu, 0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u};

static __constant__ uint32_t kIV[8] = {
    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au, 0x510E527Fu, 0x9B05688Cu,
    0x1F83D9ABu, 0x5BE0CD19u};

// Message schedule of the padding block of a 64-byte message (two digests):
// W[0..15] = {0x80000000, 0, ..., 0, 512}, W[16..63] expanded.  The Merkle
// node hash's second compression runs against it with no schedule work.
static __constant__ uint32_t kPad64Sched[64] = {
    0x80000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000200u, 0x80000000u, 0x01400000u,
    0x00205000u, 0x00005088u, 0x22000800u, 0x22550014u, 0x05089742u, 0xA0000020u,
    0x5A880000u, 0x005C9400u, 0x0016D49Du, 0xFA801F00u, 0xD33225D0u, 0x11675959u,
    0xF6E6BFDAu, 0xB30C1549u, 0x08B2B050u, 0x9D7C4C27u, 0x0CE2A393u, 0x88E6E1EAu,
    0xA52B4335u, 0x67A16F49u, 0xD732016Fu, 0x4EEB2E91u, 0x5DBF55E5u, 0x8EEE2335u,
    0xE2BC5EC2u, 0xA83F4394u, 0x45AD78F7u, 0x36F3D0CDu, 0xD99C05E8u, 0xB0511DC7u,
    0x69BC7AC4u, 0xBD11375Bu, 0xE3BA71E5u, 0x3B209FF2u, 0x18FEEE17u, 0xE25AD9E7u,
    0x13375046u, 0x0515089Du, 0x4F0D0F04u, 0x2627484Eu, 0x310128D2u, 0xC668B434u,
    0x420841CCu, 0x62D311B8u, 0xE59BA771u, 0x85A7A484u};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}
__device__ __forceinline__ uint32_t bsig0(uint32_t x) {
  return rotr(x, 2) ^ rotr(x, 13) ^ rotr(x, 22);
}
__device__ __forceinline__ uint32_t bsig1(uint32_t x) {
  return rotr(x, 6) ^ rotr(x, 11) ^ rotr(x, 25);
}
__device__ __forceinline__ uint32_t ssig0(uint32_t x) {
  return rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3);
}
__device__ __forceinline__ uint32_t ssig1(uint32_t x) {
  return rotr(x, 17) ^ rotr(x, 19) ^ (x >> 10);
}

__device__ __forceinline__ void set_iv(uint32_t s[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = kIV[i];
}

// One round; kw = K[t] + W[t].  ch and maj in their 3-op and 4-op forms,
// bit-identical to the specification's.
__device__ __forceinline__ void sha_round(uint32_t v[8], uint32_t kw) {
  const uint32_t a = v[0], b = v[1], c = v[2], d = v[3];
  const uint32_t e = v[4], f = v[5], g = v[6], h = v[7];
  const uint32_t ch = g ^ (e & (f ^ g));
  const uint32_t maj = (a & (b | c)) | (b & c);
  const uint32_t t1 = h + bsig1(e) + ch + kw;
  const uint32_t t2 = bsig0(a) + maj;
  v[7] = g;
  v[6] = f;
  v[5] = e;
  v[4] = d + t1;
  v[3] = c;
  v[2] = b;
  v[1] = a;
  v[0] = t1 + t2;
}

// One compression of the 16-word block `w` into `st`.  `w` is consumed as
// the rolling schedule window: W[t] for t >= 16 overwrites W[t - 16].
__device__ __forceinline__ void compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = st[i];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      wt = ssig1(w[(t - 2) & 15]) + w[(t - 7) & 15] + ssig0(w[(t - 15) & 15]) +
           w[t & 15];
      w[t & 15] = wt;
    }
    sha_round(v, kK[t] + wt);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] += v[i];
}

// Compression of the constant padding block of a 64-byte message.
__device__ __forceinline__ void compress_pad64(uint32_t st[8]) {
  uint32_t v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = st[i];
#pragma unroll
  for (int t = 0; t < 64; ++t) sha_round(v, kK[t] + kPad64Sched[t]);
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] += v[i];
}

// Merkle node hash sha256(left || right): one data compression plus one
// against the constant padding schedule.
__device__ __forceinline__ void node_hash(const uint32_t left[8],
                                          const uint32_t right[8],
                                          uint32_t out[8]) {
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    w[i] = left[i];
    w[8 + i] = right[i];
  }
  set_iv(out);
  compress(out, w);
  compress_pad64(out);
}

// SHA-256 of an n-word big-endian message whose word j is word(j).  The
// padding words (0x80000000, zeros, 64-bit bit length) are produced here,
// so the lane runs ceil((n + 3) / 16) compressions over its message alone.
template <class Word>
__device__ __forceinline__ void sha256_message(const Word& word, int n,
                                               uint32_t st[8]) {
  const int n_blocks = (n + 3 + 15) / 16;
  const int total = 16 * n_blocks;
  const uint64_t bit_len = static_cast<uint64_t>(n) * 32u;
  set_iv(st);
#pragma unroll 1
  for (int blk = 0; blk < n_blocks; ++blk) {
    uint32_t w[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int j = 16 * blk + k;
      uint32_t x = 0u;
      if (j < n) {
        x = word(j);
      } else if (j == n) {
        x = 0x80000000u;
      } else if (j == total - 2) {
        x = static_cast<uint32_t>(bit_len >> 32);
      } else if (j == total - 1) {
        x = static_cast<uint32_t>(bit_len);
      }
      w[k] = x;
    }
    compress(st, w);
  }
}

// The message's word j lies at msg[j * stride] (a lane of a word-major
// array).
__device__ __forceinline__ void sha256_strided(const uint32_t* __restrict__ msg,
                                               size_t stride, int n,
                                               uint32_t st[8]) {
  sha256_message([&](int j) { return msg[static_cast<size_t>(j) * stride]; }, n,
                 st);
}

// The message's word j is the low half of msg[j] (a row of a lane-major
// int64 array, whose elements hold words in [0, 2^32)).
__device__ __forceinline__ void sha256_lanes(const uint64_t* msg, int n,
                                             uint32_t st[8]) {
  sha256_message([&](int j) { return static_cast<uint32_t>(msg[j]); }, n, st);
}

// One level of a Merkle walk: the low index bit puts the sibling digest on
// the left (odd) or on the right (even) of `cur`, which becomes the node
// hash.
__device__ __forceinline__ void merkle_node(uint32_t cur[8], uint32_t idx,
                                            const uint32_t sib[8]) {
  uint32_t l[8], r[8];
  const bool odd = (idx & 1u) != 0u;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    l[k] = odd ? sib[k] : cur[k];
    r[k] = odd ? cur[k] : sib[k];
  }
  node_hash(l, r, cur);
}

// merkle_node with the sibling's word k at s[k * stride].
__device__ __forceinline__ void merkle_step(uint32_t cur[8], uint32_t idx,
                                            const uint32_t* __restrict__ s,
                                            size_t stride) {
  uint32_t sib[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) sib[k] = s[static_cast<size_t>(k) * stride];
  merkle_node(cur, idx, sib);
}

}  // namespace stpu
