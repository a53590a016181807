// Blocked Bloom filter kernels for Hopper (sm_90a): bulk contains and add
// for the sbf / bbf / rbbf / csbf variants.
//
// Replaces the four Pallas entry points of repro/kernels/sbf.py:
//   bloom_contains_kernel <- contains_vmem (_contains_vmem_kernel,
//                            _contains_vmem_gather_kernel,
//                            _contains_vmem_coop_kernel) and contains_hbm
//                            (_contains_hbm_kernel, _contains_hbm_coop_kernel)
//   bloom_add_kernel      <- add_vmem (_add_vmem_kernel,
//                            _add_vmem_gather_kernel, _add_vmem_coop_kernel)
//                            and add_hbm (_add_hbm_kernel)
//
// Design. A TPU core must either pin the filter in VMEM or stream blocks
// through a DMA ring, and it has no atomics, so the Pallas kernels sort each
// tile by block and own every read-modify-write. Hopper needs neither split:
// every thread walks its own keys, the L2 holds a filter up to its size, and
// L2 atomics make an unordered insert exact.
//
// * bloom_contains_kernel<S, PHI, DEPTH>: a thread owns DEPTH keys (strided
//   by blockDim so key loads coalesce). It hashes all DEPTH keys with both
//   xxh32 streams (the lane products are shared, which is mix="cheap"; the
//   result is the same as mix="full"), issues every block load (PHI-word
//   vector loads, at most 128 bits) before it tests any of them, builds the
//   masks from the salts, and tests (w & m) == m chunk by chunk, stopping at
//   the first failing chunk. The DEPTH loads a thread keeps in flight take
//   the place of contains_hbm's DMA ring. One byte is written per key.
//   Bound: the DRAM regime is bound by DRAM bytes (one 32-byte sector per
//   key for B = 256, in random order); the L2 regime by L2 bandwidth and
//   integer issue (about 100 integer ops per key for k = 16).
// * bloom_add_kernel<S>: one thread per key hashes it, builds its mask and
//   atomicOr's every nonzero mask word into its block. OR commutes and is
//   idempotent, so the words equal the sequential reference bit for bit in
//   any order. Bound: L2 atomic throughput in both regimes (atomics execute
//   in L2; in the DRAM regime each touched line is also fetched from DRAM).
//   The TPU's block sort (sbf.py _add_hbm_kernel) existed only because the
//   TPU has no atomics; a sorted, coalesced add is later work.
//
// Salts (3 x 96 u32: bit salts, bbf word salts, csbf group salts) arrive as
// a device pointer and are staged in shared memory once per CTA. The
// variant, k, z, log2 g and n_blocks - 1 are kernel arguments; S, PHI and
// DEPTH are template parameters so the per-key words and masks live in
// registers.
//
// C interface for ctypes: each entry point returns cudaGetLastError() after
// its launch (or -1 for a shape that has no instantiation).

#include "bloom_common.cuh"

namespace {

template <int S, int PHI, int DEPTH>
__global__ void __launch_bounds__(kThreads)
    bloom_contains_kernel(const uint2* __restrict__ keys,
                          const uint32_t* __restrict__ words,
                          bool* __restrict__ out,
                          const uint32_t* __restrict__ salts, int64_t n,
                          uint32_t block_mask, int variant, int k, int z,
                          int log2g) {
  static_assert(S % PHI == 0, "PHI must divide S");
  __shared__ uint32_t smem[3 * kMaxSalts];
  stage_salts(smem, salts);

  const int64_t base =
      int64_t(blockIdx.x) * (kThreads * DEPTH) + threadIdx.x;
  uint32_t h_pat[DEPTH];
  uint32_t w[DEPTH][S];
  // phase 1: hash every key and issue every block load
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) {
    const int64_t i = base + int64_t(d) * kThreads;
    const bool live = i < n;
    uint32_t h_blk = 0u;
    h_pat[d] = 0u;
    if (live) hash_key(keys[i], h_pat[d], h_blk);
    const uint32_t* row =
        words + uint64_t(h_blk & block_mask) * uint64_t(S);
#pragma unroll
    for (int c = 0; c < S / PHI; ++c) {
      if (live) {
        Vec<PHI>::load(row + c * PHI, &w[d][c * PHI]);
      } else {
#pragma unroll
        for (int j = 0; j < PHI; ++j) w[d][c * PHI + j] = 0u;
      }
    }
  }
  // phase 2: masks and the early-exit test, key by key
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) {
    const int64_t i = base + int64_t(d) * kThreads;
    if (i >= n) break;
    uint32_t m[S];
    build_mask<S>(m, h_pat[d], smem, smem + kMaxSalts, smem + 2 * kMaxSalts,
                  variant, k, z, log2g);
    bool ok = true;
#pragma unroll
    for (int c = 0; c < S / PHI; ++c) {
      uint32_t miss = 0u;
#pragma unroll
      for (int j = 0; j < PHI; ++j) miss |= m[c * PHI + j] & ~w[d][c * PHI + j];
      if (miss) {
        ok = false;
        break;
      }
    }
    out[i] = ok;
  }
}

template <int S>
__global__ void __launch_bounds__(kThreads)
    bloom_add_kernel(const uint2* __restrict__ keys, uint32_t* words,
                     const uint32_t* __restrict__ salts, int64_t n,
                     uint32_t block_mask, int variant, int k, int z,
                     int log2g) {
  __shared__ uint32_t smem[3 * kMaxSalts];
  stage_salts(smem, salts);
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t h_pat, h_blk;
  hash_key(keys[i], h_pat, h_blk);
  uint32_t m[S];
  build_mask<S>(m, h_pat, smem, smem + kMaxSalts, smem + 2 * kMaxSalts,
                variant, k, z, log2g);
  uint32_t* row = words + uint64_t(h_blk & block_mask) * uint64_t(S);
#pragma unroll
  for (int j = 0; j < S; ++j)
    if (m[j]) atomicOr(row + j, m[j]);
}

template <int S, int PHI, int DEPTH>
int launch_contains(const void* keys, const void* words, void* out,
                    const void* salts, int64_t n, uint32_t block_mask,
                    int variant, int k, int z, int log2g,
                    cudaStream_t stream) {
  const int64_t per_cta = int64_t(kThreads) * DEPTH;
  const unsigned grid = unsigned((n + per_cta - 1) / per_cta);
  bloom_contains_kernel<S, PHI, DEPTH><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint2*>(keys), static_cast<const uint32_t*>(words),
      static_cast<bool*>(out), static_cast<const uint32_t*>(salts), n,
      block_mask, variant, k, z, log2g);
  return int(cudaGetLastError());
}

template <int S, int PHI>
int dispatch_depth(int depth, const void* keys, const void* words, void* out,
                   const void* salts, int64_t n, uint32_t block_mask,
                   int variant, int k, int z, int log2g, cudaStream_t st) {
  // contains_vmem runs DEPTH = 1 at any PHI; contains_hbm runs the widest
  // PHI at any DEPTH, with at most 64 block words in flight per thread
  constexpr bool kDeep = PHI == (S < 4 ? S : 4);
  if (depth > 1 && !kDeep) return -1;
  switch (depth) {
    case 1:
      return launch_contains<S, PHI, 1>(keys, words, out, salts, n,
                                        block_mask, variant, k, z, log2g, st);
    case 2:
      if constexpr (kDeep && 2 * S <= 64)
        return launch_contains<S, PHI, 2>(keys, words, out, salts, n,
                                          block_mask, variant, k, z, log2g,
                                          st);
      break;
    case 4:
      if constexpr (kDeep && 4 * S <= 64)
        return launch_contains<S, PHI, 4>(keys, words, out, salts, n,
                                          block_mask, variant, k, z, log2g,
                                          st);
      break;
    case 8:
      if constexpr (kDeep && 8 * S <= 64)
        return launch_contains<S, PHI, 8>(keys, words, out, salts, n,
                                          block_mask, variant, k, z, log2g,
                                          st);
      break;
  }
  return -1;
}

template <int S>
int dispatch_phi(int phi, int depth, const void* keys, const void* words,
                 void* out, const void* salts, int64_t n, uint32_t block_mask,
                 int variant, int k, int z, int log2g, cudaStream_t st) {
  switch (phi) {
    case 1:
      return dispatch_depth<S, 1>(depth, keys, words, out, salts, n,
                                  block_mask, variant, k, z, log2g, st);
    case 2:
      if constexpr (S >= 2)
        return dispatch_depth<S, 2>(depth, keys, words, out, salts, n,
                                    block_mask, variant, k, z, log2g, st);
      break;
    case 4:
      if constexpr (S >= 4)
        return dispatch_depth<S, 4>(depth, keys, words, out, salts, n,
                                    block_mask, variant, k, z, log2g, st);
      break;
  }
  return -1;
}

template <int S>
int launch_add(const void* keys, void* words, const void* salts, int64_t n,
               uint32_t block_mask, int variant, int k, int z, int log2g,
               cudaStream_t stream) {
  const unsigned grid = unsigned((n + kThreads - 1) / kThreads);
  bloom_add_kernel<S><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint2*>(keys), static_cast<uint32_t*>(words),
      static_cast<const uint32_t*>(salts), n, block_mask, variant, k, z,
      log2g);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// keys: (n, 2) int32 [hi, lo], 8-byte aligned; words: (n_words,) int32,
// 16-byte aligned; out: (n,) bool; salts: (3, 96) int32.
int bloom_contains(const void* keys, const void* words, void* out,
                   const void* salts, long long n, unsigned block_mask, int s,
                   int phi, int depth, int variant, int k, int z, int log2g,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (s) {
    case 1:
      return dispatch_phi<1>(phi, depth, keys, words, out, salts, n,
                             block_mask, variant, k, z, log2g, st);
    case 2:
      return dispatch_phi<2>(phi, depth, keys, words, out, salts, n,
                             block_mask, variant, k, z, log2g, st);
    case 4:
      return dispatch_phi<4>(phi, depth, keys, words, out, salts, n,
                             block_mask, variant, k, z, log2g, st);
    case 8:
      return dispatch_phi<8>(phi, depth, keys, words, out, salts, n,
                             block_mask, variant, k, z, log2g, st);
    case 16:
      return dispatch_phi<16>(phi, depth, keys, words, out, salts, n,
                              block_mask, variant, k, z, log2g, st);
    case 32:
      return dispatch_phi<32>(phi, depth, keys, words, out, salts, n,
                              block_mask, variant, k, z, log2g, st);
  }
  return -1;
}

int bloom_add(const void* keys, void* words, const void* salts, long long n,
              unsigned block_mask, int s, int variant, int k, int z,
              int log2g, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (s) {
    case 1:
      return launch_add<1>(keys, words, salts, n, block_mask, variant, k, z,
                           log2g, st);
    case 2:
      return launch_add<2>(keys, words, salts, n, block_mask, variant, k, z,
                           log2g, st);
    case 4:
      return launch_add<4>(keys, words, salts, n, block_mask, variant, k, z,
                           log2g, st);
    case 8:
      return launch_add<8>(keys, words, salts, n, block_mask, variant, k, z,
                           log2g, st);
    case 16:
      return launch_add<16>(keys, words, salts, n, block_mask, variant, k, z,
                            log2g, st);
    case 32:
      return launch_add<32>(keys, words, salts, n, block_mask, variant, k, z,
                            log2g, st);
  }
  return -1;
}

}  // extern "C"
