// Generation-ring membership kernel for Hopper (sm_90a): bulk contains
// against a windowed filter's (G, n_words) ring of same-spec generations,
// for the sbf / bbf / rbbf / csbf variants.
//
// Replaces the two Pallas entry points of repro/kernels/ring.py:
//   ring_contains_kernel<S, PHI, 1>     <- ring_contains_vmem
//                                          (_ring_vmem_kernel)
//   ring_contains_kernel<S, PHI, DEPTH> <- ring_contains_hbm
//                                          (_ring_hbm_kernel)
//
// A key is in the window iff its mask is covered by the OR of its block row
// over the G generations: contains(OR of the generations), computed without
// materialising the O(m) union.
//
// Design. Each key is hashed once (both xxh32 streams share the lane
// products). Its block row sits at blk * S in every generation, generation
// g at g * n_words (64-bit offsets). For each PHI-word chunk of the row the
// kernel loads that chunk from each of the G generations, ORs them and
// tests the mask, and it stops at the first chunk that fails. A thread owns
// DEPTH keys (strided by blockDim so key loads coalesce): the first chunk's
// G loads of all DEPTH keys are issued before any test, which takes the
// place of _ring_hbm_kernel's double-buffered DMA across generations; later
// chunks are loaded only for keys whose earlier chunks passed. G is a
// runtime argument; a chunk's G loads are unrolled in groups of
// kGenUnroll = 4, so DEPTH * kGenUnroll * PHI <= 64 words are in flight.
// PHI = min(S, 4) (128-bit loads) in both regimes.
//
// Bound: in the DRAM regime G random 32-byte sectors a key for B = 256 (the
// rows of G generations are G lines apart); in the L2 regime L2 bandwidth and
// integer issue (the mask costs as much as in bloom_contains_kernel).
//
// Salts (3 x 96 u32) are staged in shared memory once per CTA; the masks
// come from bloom_common.cuh's build_mask, as in bloom.cu.
//
// C interface for ctypes: the entry point returns cudaGetLastError() after
// its launch, 0 for n == 0 (nothing launched), or -1 for a shape that has
// no instantiation.

#include "bloom_common.cuh"

namespace {

constexpr int kGenUnroll = 4;

// acc = OR over the n_gen generations of the PHI words at p + g * stride.
template <int PHI>
__device__ __forceinline__ void or_generations(const uint32_t* p,
                                               int64_t stride, int n_gen,
                                               uint32_t (&acc)[PHI]) {
#pragma unroll
  for (int j = 0; j < PHI; ++j) acc[j] = 0u;
  for (int g0 = 0; g0 < n_gen; g0 += kGenUnroll) {
    uint32_t v[kGenUnroll][PHI];
#pragma unroll
    for (int t = 0; t < kGenUnroll; ++t) {
      if (g0 + t < n_gen) {
        Vec<PHI>::load(p + int64_t(g0 + t) * stride, v[t]);
      } else {
#pragma unroll
        for (int j = 0; j < PHI; ++j) v[t][j] = 0u;
      }
    }
#pragma unroll
    for (int t = 0; t < kGenUnroll; ++t)
#pragma unroll
      for (int j = 0; j < PHI; ++j) acc[j] |= v[t][j];
  }
}

template <int S, int PHI, int DEPTH>
__global__ void __launch_bounds__(kThreads)
    ring_contains_kernel(const uint2* __restrict__ keys,
                         const uint32_t* __restrict__ rings,
                         bool* __restrict__ out,
                         const uint32_t* __restrict__ salts, int64_t n,
                         int64_t n_words, int n_gen, uint32_t block_mask,
                         int variant, int k, int z, int log2g) {
  static_assert(S % PHI == 0, "PHI must divide S");
  __shared__ uint32_t smem[3 * kMaxSalts];
  stage_salts(smem, salts);

  const int64_t base =
      int64_t(blockIdx.x) * (kThreads * DEPTH) + threadIdx.x;
  uint32_t h_pat[DEPTH];
  const uint32_t* row[DEPTH];
  uint32_t acc[DEPTH][PHI];
  // phase 1: hash every key, then issue chunk 0's loads from every
  // generation for every key before any test
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) {
    const int64_t i = base + int64_t(d) * kThreads;
    uint32_t h_blk = 0u;
    h_pat[d] = 0u;
    if (i < n) hash_key(keys[i], h_pat[d], h_blk);
    row[d] = rings + uint64_t(h_blk & block_mask) * uint64_t(S);
#pragma unroll
    for (int j = 0; j < PHI; ++j) acc[d][j] = 0u;
  }
  for (int g0 = 0; g0 < n_gen; g0 += kGenUnroll) {
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      const bool live = base + int64_t(d) * kThreads < n;
      uint32_t v[kGenUnroll][PHI];
#pragma unroll
      for (int t = 0; t < kGenUnroll; ++t) {
        if (live && g0 + t < n_gen) {
          Vec<PHI>::load(row[d] + int64_t(g0 + t) * n_words, v[t]);
        } else {
#pragma unroll
          for (int j = 0; j < PHI; ++j) v[t][j] = 0u;
        }
      }
#pragma unroll
      for (int t = 0; t < kGenUnroll; ++t)
#pragma unroll
        for (int j = 0; j < PHI; ++j) acc[d][j] |= v[t][j];
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
    uint32_t miss = 0u;
#pragma unroll
    for (int j = 0; j < PHI; ++j) miss |= m[j] & ~acc[d][j];
    bool ok = miss == 0u;
#pragma unroll
    for (int c = 1; c < S / PHI; ++c) {
      if (!ok) break;
      uint32_t w[PHI];
      or_generations<PHI>(row[d] + c * PHI, n_words, n_gen, w);
      miss = 0u;
#pragma unroll
      for (int j = 0; j < PHI; ++j) miss |= m[c * PHI + j] & ~w[j];
      ok = miss == 0u;
    }
    out[i] = ok;
  }
}

template <int S, int DEPTH>
int launch_ring(const void* keys, const void* rings, void* out,
                const void* salts, int64_t n, int64_t n_words, int n_gen,
                uint32_t block_mask, int variant, int k, int z, int log2g,
                cudaStream_t stream) {
  constexpr int PHI = S < 4 ? S : 4;
  const int64_t per_cta = int64_t(kThreads) * DEPTH;
  const unsigned grid = unsigned((n + per_cta - 1) / per_cta);
  ring_contains_kernel<S, PHI, DEPTH><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint2*>(keys), static_cast<const uint32_t*>(rings),
      static_cast<bool*>(out), static_cast<const uint32_t*>(salts), n,
      n_words, n_gen, block_mask, variant, k, z, log2g);
  return int(cudaGetLastError());
}

template <int S>
int dispatch_depth(int depth, const void* keys, const void* rings, void* out,
                   const void* salts, int64_t n, int64_t n_words, int n_gen,
                   uint32_t block_mask, int variant, int k, int z, int log2g,
                   cudaStream_t st) {
  switch (depth) {
    case 1:
      return launch_ring<S, 1>(keys, rings, out, salts, n, n_words, n_gen,
                               block_mask, variant, k, z, log2g, st);
    case 2:
      return launch_ring<S, 2>(keys, rings, out, salts, n, n_words, n_gen,
                               block_mask, variant, k, z, log2g, st);
    case 4:
      return launch_ring<S, 4>(keys, rings, out, salts, n, n_words, n_gen,
                               block_mask, variant, k, z, log2g, st);
  }
  return -1;
}

}  // namespace

extern "C" {

// keys: (n, 2) int32 [hi, lo], 8-byte aligned; rings: (n_gen, n_words)
// int32, 16-byte aligned; out: (n,) bool; salts: (3, 96) int32.
int ring_contains(const void* keys, const void* rings, void* out,
                  const void* salts, long long n, long long n_words,
                  int n_gen, unsigned block_mask, int s, int depth,
                  int variant, int k, int z, int log2g, void* stream) {
  if (n_gen < 1) return -1;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (s) {
    case 1:
      return dispatch_depth<1>(depth, keys, rings, out, salts, n, n_words,
                               n_gen, block_mask, variant, k, z, log2g, st);
    case 2:
      return dispatch_depth<2>(depth, keys, rings, out, salts, n, n_words,
                               n_gen, block_mask, variant, k, z, log2g, st);
    case 4:
      return dispatch_depth<4>(depth, keys, rings, out, salts, n, n_words,
                               n_gen, block_mask, variant, k, z, log2g, st);
    case 8:
      return dispatch_depth<8>(depth, keys, rings, out, salts, n, n_words,
                               n_gen, block_mask, variant, k, z, log2g, st);
    case 16:
      return dispatch_depth<16>(depth, keys, rings, out, salts, n, n_words,
                                n_gen, block_mask, variant, k, z, log2g, st);
    case 32:
      return dispatch_depth<32>(depth, keys, rings, out, salts, n, n_words,
                                n_gen, block_mask, variant, k, z, log2g, st);
  }
  return -1;
}

}  // extern "C"
