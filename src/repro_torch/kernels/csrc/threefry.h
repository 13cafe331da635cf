// Threefry-2x32 with 20 rounds, as jax.random computes it in its
// partitionable mode (and repro_torch/random.py in torch), and the draws of
// the fused training epoch built on it.
//
// Plain C++: nvcc compiles it for host and device, and a host compiler
// builds it alone (tests/test_torch_epoch.py holds it against jax.random).
//
// * bits(key, i): the hash of the counter (0, i) under the key, its two
//   words XORed: element i of jax.random.bits(key, shape) over the flat
//   index of a shape of fewer than 2**31 elements;
// * uniform(b): jax.random.uniform's float32 from those bits, the top 23
//   bits as the mantissa of a float in [1, 2), minus 1;
// * coin(...): one Type I coin of the fused epoch, the bit of its coin
//   plane (repro/kernels/draws.py) that the update reads, from one hash;
// * sample_chain(...): one sample's share of an epoch's key chain, its
//   class pair and role keys (csrc/key_chain.cu runs it a thread).
#pragma once

#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#define THREEFRY_HD __host__ __device__ __forceinline__
#else
#define THREEFRY_HD inline
#endif

namespace threefry {

THREEFRY_HD uint32_t rotl(uint32_t x, int r) {
#ifdef __CUDA_ARCH__
  return __funnelshift_l(x, x, r);
#else
  return (x << r) | (x >> (32 - r));
#endif
}

// A key's two words and its third schedule word.
struct Key {
  uint32_t k0, k1, k2;
};

THREEFRY_HD Key make_key(uint32_t k0, uint32_t k1) {
  return Key{k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
}

// Four rounds of mixing with the rotations of one half of the schedule.
THREEFRY_HD void rounds(uint32_t& x0, uint32_t& x1, int r0, int r1, int r2,
                        int r3) {
  x0 += x1; x1 = rotl(x1, r0); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, r1); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, r2); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, r3); x1 ^= x0;
}

// threefry2x32 of the counter (x0, x1) under k, in place.
THREEFRY_HD void hash(const Key& k, uint32_t& x0, uint32_t& x1) {
  x0 += k.k0;
  x1 += k.k1;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += k.k1; x1 += k.k2 + 1u;
  rounds(x0, x1, 17, 29, 16, 24);
  x0 += k.k2; x1 += k.k0 + 2u;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += k.k0; x1 += k.k1 + 3u;
  rounds(x0, x1, 17, 29, 16, 24);
  x0 += k.k1; x1 += k.k2 + 4u;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += k.k2; x1 += k.k0 + 5u;
}

// jax.random.bits(key, shape) at flat index i.
THREEFRY_HD uint32_t bits(const Key& k, uint32_t i) {
  uint32_t x0 = 0u, x1 = i;
  hash(k, x0, x1);
  return x0 ^ x1;
}

// The 23 bits that jax.random.uniform keeps.
THREEFRY_HD uint32_t mantissa(uint32_t b) { return b >> 9; }

// jax.random.uniform (float32, [0, 1)) from the bits b.
THREEFRY_HD float uniform(uint32_t b) {
  const uint32_t one_to_two = mantissa(b) | 0x3F800000u;
#ifdef __CUDA_ARCH__
  const float f = __uint_as_float(one_to_two);
#else
  float f;
  std::memcpy(&f, &one_to_two, sizeof f);
#endif
  return f - 1.0f;
}

// The counter of literal l of clause j in a role's (m, L) coin plane.
THREEFRY_HD uint32_t coin_counter(int j, int l, int L) {
  return (uint32_t)j * (uint32_t)L + (uint32_t)l;
}

// Whether every counter of an (m, L) plane is below 2**31, as
// repro_torch/random.py requires of one draw (jax's counters above that
// take a second word, which neither implements).
inline bool counters_fit(long long m, long long L) {
  return m >= 0 && L >= 0 && m * L < (1LL << 31);
}

// The Type I coin of literal l of clause j in one role: where the literal
// is hit (the clause fired and the literal is 1) the increment draw,
// uniform(k_s1) < p_inc, else the decrement draw, uniform(k_s2) < p_dec;
// t_inc and t_dec are draws.int_threshold of the two probabilities, so
// the compare is exact in integers.  Only the draw the update reads is
// hashed: one hash per literal where the coin plane holds two.
THREEFRY_HD bool coin(const Key& k_s1, const Key& k_s2, uint32_t t_inc,
                      uint32_t t_dec, uint32_t counter, bool hit) {
  const Key k = hit ? k_s1 : k_s2;
  return mantissa(bits(k, counter)) < (hit ? t_inc : t_dec);
}

// jax.random.split(key, n)[i], which is also fold_in(key, i): the hash of
// the counter (0, i) under the key, both words kept.
THREEFRY_HD Key split_at(const Key& k, uint32_t i) {
  uint32_t x0 = 0u, x1 = i;
  hash(k, x0, x1);
  return make_key(x0, x1);
}

// jax.random.randint(key, (), lo, lo + span) - lo, for 1 <= span <= 2**31:
// a word from each half of split(key), folded into the span by jax's
// modular recipe in wrapping uint32 arithmetic.
THREEFRY_HD uint32_t randint_offset(const Key& k, uint32_t span) {
  const uint32_t higher = bits(split_at(k, 0u), 0u);
  const uint32_t lower = bits(split_at(k, 1u), 0u);
  uint32_t mult = 65536u % span;
  mult = mult * mult % span;
  return ((higher % span) * mult + lower % span) % span;
}

// One sample's share of a local epoch's key chain (repro/core/tm.py, one
// epoch of train_batched: the keys of repro/kernels/draws.py epoch_draws
// and the class pair), from one client's key (k0, k1):
//   epoch key   split(client key, epochs)[epoch], or the client key itself
//               where epoch < 0 (the caller holds the epoch key);
//   sample key  split(epoch key, S)[i];
//   k_neg, k_t, k_n = split(sample key, 3);
//   cls         [y, (y + randint(k_neg, (), 1, C)) % C], y taken as int32
//               and the sum wrapping, the remainder's sign the divisor's
//               (torch's int32 "%");
//   role[r]     [k_act, k_s1, k_s2] = split(k_t, 3) for r = 0 (target),
//               split(k_n, 3) for r = 1 (negative).
// 15 hashes (14 where epoch < 0).  C >= 1; C = 1 takes randint's empty
// span, an offset of 1.
struct SampleChain {
  int32_t cls[2];
  uint32_t role[2][3][2];  // role, [k_act, k_s1, k_s2], the key's words
};

THREEFRY_HD SampleChain sample_chain(uint32_t k0, uint32_t k1, int epoch,
                                     uint32_t i, int32_t y, int32_t C) {
  Key k = make_key(k0, k1);
  if (epoch >= 0) k = split_at(k, (uint32_t)epoch);
  const Key sample = split_at(k, i);
  const uint32_t span = C > 1 ? (uint32_t)(C - 1) : 1u;
  const uint32_t offset = 1u + randint_offset(split_at(sample, 0u), span);
  int32_t neg = (int32_t)((uint32_t)y + offset) % C;
  if (neg < 0) neg += C;
  SampleChain out;
  out.cls[0] = y;
  out.cls[1] = neg;
  for (int r = 0; r < 2; ++r) {
    const Key role = split_at(sample, 1u + (uint32_t)r);
    for (int j = 0; j < 3; ++j) {
      const Key kj = split_at(role, (uint32_t)j);
      out.role[r][j][0] = kj.k0;
      out.role[r][j][1] = kj.k1;
    }
  }
  return out;
}

}  // namespace threefry
