// Classical Bloom filter kernels for Hopper (sm_90a): bulk contains and add
// for the cbf variant, k single-bit probes anywhere in m bits.
//
// Replaces the two Pallas entry points of repro/kernels/cbf.py:
//   cbf_contains_kernel <- contains_vmem (_contains_kernel)
//   cbf_add_kernel      <- add_vmem (_add_kernel)
//
// Design. The classical filter has no block locality: key i's bit t lies at
// pos = ((h1 + t * h2) * SALTS[t]) >> (32 - log2 m) (variants.py
// cbf_positions, Kirsch-Mitzenmacher double hashing re-mixed by a salted
// mul-shift; at m = 2^32 the shift is 0 and all 32 bits are kept), in word
// pos >> 5. The JAX package runs it only with the filter pinned in VMEM (a
// DRAM cbf on the TPU needs k DMAs a key) and sends larger classical filters
// to its jnp engine. On Hopper a probe is one load wherever the word lives,
// so this one kernel pair serves a filter in L2 and one in DRAM; the regime
// never changes a result.
//
// * cbf_contains_kernel: one thread per key hashes it once (both xxh32
//   streams share the lane products) and walks its k positions in groups of
//   kGroup = 8: the group's 8 word loads are issued together, then tested,
//   and the walk stops after the first group with a miss. A key that is not
//   in the filter fails each probe with probability about 1/2 at the
//   space-optimal fill, so nearly every such key stops after one group, and
//   a member key keeps 8 independent loads in flight. Bound: in the DRAM
//   regime one random 32-byte sector per probe (k sectors for a member key,
//   about 8 for a non-member); in the L2 regime L2 bandwidth and integer
//   issue (~6 integer ops per probe after the ~40 of the hash).
// * cbf_add_kernel: one thread per key, one atomicOr per position (its
//   result unused, so a fire-and-forget reduction). OR commutes and is
//   idempotent, so the words equal the sequential reference bit for bit in
//   any order. Bound: L2 atomic throughput, k atomics a key, on lines
//   fetched from DRAM in the DRAM regime.
//
// The bit salts (SALTS, the first row of the 3 x 96 salt table) are staged
// in shared memory once per CTA. Word offsets are pos >> 5 < 2^27.
//
// C interface for ctypes: each entry point returns cudaGetLastError() after
// its launch, 0 for n == 0 (nothing launched), or -1 for a geometry that has
// no kernel (log2 m outside [5, 32], k outside [1, 96]).

#include "bloom_common.cuh"

namespace {

constexpr int kGroup = 8;

__device__ __forceinline__ uint32_t cbf_position(uint32_t h1, uint32_t h2,
                                                 int t, uint32_t salt,
                                                 int shift) {
  return ((h1 + uint32_t(t) * h2) * salt) >> shift;
}

__global__ void __launch_bounds__(kThreads)
    cbf_contains_kernel(const uint2* __restrict__ keys,
                        const uint32_t* __restrict__ words,
                        bool* __restrict__ out,
                        const uint32_t* __restrict__ salts, int64_t n,
                        int shift, int k) {
  __shared__ uint32_t smem[3 * kMaxSalts];
  stage_salts(smem, salts);
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t h1, h2;
  hash_key(keys[i], h1, h2);
  bool ok = true;
  for (int t0 = 0; t0 < k && ok; t0 += kGroup) {
    uint32_t w[kGroup], bit[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {     // issue the group's loads
      const int t = t0 + j;
      if (t < k) {
        const uint32_t pos = cbf_position(h1, h2, t, smem[t], shift);
        w[j] = __ldg(words + (pos >> 5));
        bit[j] = 1u << (pos & 31u);
      } else {
        w[j] = 1u;
        bit[j] = 1u;
      }
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) ok = ok && (w[j] & bit[j]) != 0u;
  }
  out[i] = ok;
}

__global__ void __launch_bounds__(kThreads)
    cbf_add_kernel(const uint2* __restrict__ keys, uint32_t* words,
                   const uint32_t* __restrict__ salts, int64_t n, int shift,
                   int k) {
  __shared__ uint32_t smem[3 * kMaxSalts];
  stage_salts(smem, salts);
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t h1, h2;
  hash_key(keys[i], h1, h2);
  for (int t = 0; t < k; ++t) {
    const uint32_t pos = cbf_position(h1, h2, t, smem[t], shift);
    atomicOr(words + (pos >> 5), 1u << (pos & 31u));
  }
}

bool bad_geometry(int log2m, int k) {
  return log2m < 5 || log2m > 32 || k < 1 || k > kMaxSalts;
}

unsigned grid_for(long long n) {
  return unsigned((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// keys: (n, 2) int32 [hi, lo], 8-byte aligned; words: (m / 32,) int32;
// out: (n,) bool; salts: (3, 96) int32; log2m = log2(m_bits).
int cbf_contains(const void* keys, const void* words, void* out,
                 const void* salts, long long n, int log2m, int k,
                 void* stream) {
  if (bad_geometry(log2m, k)) return -1;
  if (n == 0) return 0;
  cbf_contains_kernel<<<grid_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(keys), static_cast<const uint32_t*>(words),
      static_cast<bool*>(out), static_cast<const uint32_t*>(salts), n,
      32 - log2m, k);
  return int(cudaGetLastError());
}

int cbf_add(const void* keys, void* words, const void* salts, long long n,
            int log2m, int k, void* stream) {
  if (bad_geometry(log2m, k)) return -1;
  if (n == 0) return 0;
  cbf_add_kernel<<<grid_for(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(keys), static_cast<uint32_t*>(words),
      static_cast<const uint32_t*>(salts), n, 32 - log2m, k);
  return int(cudaGetLastError());
}

}  // extern "C"
