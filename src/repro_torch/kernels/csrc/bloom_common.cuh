// Device code shared by the blocked Bloom kernels (bloom.cu) and the
// counting Bloom kernels (counting.cu): the two xxh32 key hashes, the
// s-word mask builder of variants.py block_patterns, the salt staging and
// the vector loads. Everything sits in an anonymous namespace, so each
// library that includes it gets its own copy.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSalts = 96;
constexpr int kThreads = 256;

enum Variant : int { kSbf = 0, kBbf = 1, kCsbf = 2 };  // rbbf is bbf, S = 1

constexpr uint32_t P2 = 2246822519u;
constexpr uint32_t P3 = 3266489917u;
constexpr uint32_t P4 = 668265263u;
constexpr uint32_t P5 = 374761393u;
constexpr uint32_t kSeedPattern = 0xCAFEBABEu;
constexpr uint32_t kSeedBlock = 0xDEADBEEFu;

__device__ __forceinline__ uint32_t rotl17(uint32_t x) {
  return (x << 17) | (x >> 15);
}

// xxHash32 of an 8-byte key from its precomputed lane products (lo first).
__device__ __forceinline__ uint32_t xxh32_from_products(uint32_t plo,
                                                        uint32_t phi,
                                                        uint32_t seed) {
  uint32_t acc = seed + P5 + 8u;
  acc = rotl17(acc + plo) * P4;
  acc = rotl17(acc + phi) * P4;
  acc ^= acc >> 15;
  acc *= P2;
  acc ^= acc >> 13;
  acc *= P3;
  acc ^= acc >> 16;
  return acc;
}

// Keys are stored [hi, lo]; xxh32 consumes lo before hi.
__device__ __forceinline__ void hash_key(uint2 key, uint32_t& h_pattern,
                                         uint32_t& h_block) {
  const uint32_t plo = key.y * P3;
  const uint32_t phi = key.x * P3;
  h_pattern = xxh32_from_products(plo, phi, kSeedPattern);
  h_block = xxh32_from_products(plo, phi, kSeedBlock);
}

__device__ __forceinline__ uint32_t bit_of(uint32_t h, uint32_t salt) {
  return 1u << ((h * salt) >> 27);
}

__host__ __device__ constexpr int log2_of(int s) {
  return s <= 1 ? 0 : 1 + log2_of(s / 2);
}

// The s-word mask of one key (variants.py block_patterns).
template <int S>
__device__ __forceinline__ void build_mask(uint32_t (&m)[S], uint32_t h,
                                           const uint32_t* salt,
                                           const uint32_t* wsalt,
                                           const uint32_t* gsalt, int variant,
                                           int k, int z, int log2g) {
#pragma unroll
  for (int j = 0; j < S; ++j) m[j] = 0u;
  if (variant == kSbf) {
    // salt i lands in word i % S
    for (int r = 0; r < k; r += S) {
#pragma unroll
      for (int j = 0; j < S; ++j)
        if (r + j < k) m[j] |= bit_of(h, salt[r + j]);
    }
  } else if (variant == kBbf) {
    constexpr int log2s = log2_of(S);
    for (int i = 0; i < k; ++i) {
      const uint32_t bit = bit_of(h, salt[i]);
      if constexpr (log2s == 0) {
        m[0] |= bit;
      } else {
        const uint32_t w = (h * wsalt[i]) >> (32 - log2s);
#pragma unroll
        for (int j = 0; j < S; ++j) m[j] |= (w == uint32_t(j)) ? bit : 0u;
      }
    }
  } else {  // csbf: word j*g + mulshift(h, GROUP_SALTS[j], log2 g) per group
    const int kz = k / z;
    const int g = S / z;
    for (int jg = 0; jg < z; ++jg) {
      uint32_t w = uint32_t(jg * g);
      if (log2g > 0) w += (h * gsalt[jg]) >> (32 - log2g);
      uint32_t gm = 0u;
      for (int t = 0; t < kz; ++t) gm |= bit_of(h, salt[jg * kz + t]);
#pragma unroll
      for (int j = 0; j < S; ++j) m[j] |= (w == uint32_t(j)) ? gm : 0u;
    }
  }
}

// Words [first, first + W) of one key's s-word mask: build_mask's words as
// one lane of a group that splits the block builds its own share. sbf
// takes only the salts that land in its words (salt i lands in word
// i % S); bbf and csbf place bits by hash, so a lane computes each salt's
// word and builds the bits of the words it owns.
template <int S, int W>
__device__ __forceinline__ void build_mask_part(uint32_t (&m)[W], uint32_t h,
                                                int first,
                                                const uint32_t* salt,
                                                const uint32_t* wsalt,
                                                const uint32_t* gsalt,
                                                int variant, int k, int z,
                                                int log2g) {
#pragma unroll
  for (int t = 0; t < W; ++t) m[t] = 0u;
  if (variant == kSbf) {
    // salt i lands in word i % S: round r gives word first + t salt r +
    // first + t (build_mask's loop, shifted by the lane's first word)
    for (int r = first; r < k; r += S) {
#pragma unroll
      for (int t = 0; t < W; ++t)
        if (r + t < k) m[t] |= bit_of(h, salt[r + t]);
    }
  } else if (variant == kBbf) {
    constexpr int log2s = log2_of(S);
    for (int i = 0; i < k; ++i) {
      uint32_t w = 0u;
      if constexpr (log2s > 0) w = (h * wsalt[i]) >> (32 - log2s);
      w -= uint32_t(first);
      if (w < uint32_t(W)) {
        const uint32_t bit = bit_of(h, salt[i]);
#pragma unroll
        for (int t = 0; t < W; ++t) m[t] |= (w == uint32_t(t)) ? bit : 0u;
      }
    }
  } else {  // csbf: word j*g + mulshift(h, GROUP_SALTS[j], log2 g) per group
    const int kz = k / z;
    const int g = S / z;
    for (int jg = 0; jg < z; ++jg) {
      uint32_t w = uint32_t(jg * g);
      if (log2g > 0) w += (h * gsalt[jg]) >> (32 - log2g);
      w -= uint32_t(first);
      if (w < uint32_t(W)) {
        uint32_t gm = 0u;
        for (int t = 0; t < kz; ++t) gm |= bit_of(h, salt[jg * kz + t]);
#pragma unroll
        for (int t = 0; t < W; ++t) m[t] |= (w == uint32_t(t)) ? gm : 0u;
      }
    }
  }
}

// Dynamic shared memory a partitioned-update CTA may take for its segment:
// the card's opt-in limit less the statically staged salts.
inline int partition_smem_bytes(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return optin - int(3 * kMaxSalts * sizeof(uint32_t));
}

__device__ __forceinline__ void stage_salts(uint32_t* smem,
                                            const uint32_t* salts) {
  for (int i = threadIdx.x; i < 3 * kMaxSalts; i += blockDim.x)
    smem[i] = salts[i];
  __syncthreads();
}

template <int PHI>
struct Vec;
template <>
struct Vec<1> {
  __device__ __forceinline__ static void load(const uint32_t* p,
                                              uint32_t* dst) {
    dst[0] = p[0];
  }
};
template <>
struct Vec<2> {
  __device__ __forceinline__ static void load(const uint32_t* p,
                                              uint32_t* dst) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    dst[0] = v.x;
    dst[1] = v.y;
  }
};
template <>
struct Vec<4> {
  __device__ __forceinline__ static void load(const uint32_t* p,
                                              uint32_t* dst) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
};

}  // namespace
