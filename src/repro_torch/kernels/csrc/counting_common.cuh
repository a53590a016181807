// Device code shared by the counting Bloom libraries: counting.cu (the
// updates, the decay and the partitioned update) and counting_contains.cu
// (the contains, both forms). Nibble arithmetic on packed 4-bit counters and
// the per-word increments of a key's sbf-placed mask; counting.cu's header
// sets out the layout. Everything sits in an anonymous namespace, so each
// library that includes it gets its own copy.

#pragma once

#include "bloom_common.cuh"

namespace {

constexpr uint32_t kNibLsb = 0x11111111u;
constexpr unsigned kFullWarp = 0xffffffffu;

enum Op : int { kAdd = 0, kRemove = 1 };

__device__ __forceinline__ uint32_t nib_nonzero(uint32_t w) {
  return (w | (w >> 1) | (w >> 2) | (w >> 3)) & kNibLsb;
}

__device__ __forceinline__ uint32_t nib_saturated(uint32_t w) {
  return w & (w >> 1) & (w >> 2) & (w >> 3) & kNibLsb;
}

// The nibble increments one key makes in the 4 counter words of logical
// word j of its row (inc[c]: byte c of the sbf-placed mask word j, bit b
// of the byte as nibble b = 1; build_mask, kSbf: salts j, j + S, ... land
// in word j).
template <int S>
__device__ __forceinline__ void word_incs(uint32_t h, int j,
                                          const uint32_t* salt, int k,
                                          uint32_t (&inc)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) inc[c] = 0u;
  for (int r = j; r < k; r += S) {
    const uint32_t b = (h * salt[r]) >> 27;
    const uint32_t bit = 1u << (4u * (b & 7u)), c = b >> 3;
#pragma unroll
    for (int q = 0; q < 4; ++q) inc[q] |= c == uint32_t(q) ? bit : 0u;
  }
}

// First counter word of a key's row (4S words a block); a bank adds the
// member's offset (64-bit: a bank may pass 2^32 words).
template <int S, bool BANK>
__device__ __forceinline__ uint64_t counter_row(uint32_t block, uint32_t mem,
                                                uint64_t member_words) {
  uint64_t start = uint64_t(block) * uint64_t(4 * S);
  if constexpr (BANK) start += uint64_t(mem) * member_words;
  return start;
}

}  // namespace
