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
//   plane (repro/kernels/draws.py) that the update reads, from one hash.
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

}  // namespace threefry
