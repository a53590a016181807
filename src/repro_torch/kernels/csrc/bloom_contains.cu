// bloom_contains: the blocked Bloom contains (bloom_contains_kernel, the
// single-filter form) for the sbf / bbf / rbbf / csbf variants, replacing
// repro/kernels/sbf.py contains_vmem and contains_hbm. The kernel and its
// design are in bloom_blocked.cuh and bloom.cu; this library holds its
// instances (S x THETA x V x DEPTH), built beside bloom.cu's in parallel.

#include "bloom_blocked.cuh"

extern "C" {

// keys: (n, 2) int32 [hi, lo], 8-byte aligned; words: (n_words,) int32,
// 16-byte aligned; out: (n,) bool; salts: (3, 96) int32. theta: lanes a
// key; vec: words a load; depth: keys in flight a group; grid: CTAs
// (sbf.launch_geometry). Returns cudaGetLastError() after the launch, or -1
// for a shape that has no instance or a grid too small for n.
int bloom_contains(const void* keys, const void* words, void* out,
                   const void* salts, long long n, unsigned block_mask, int s,
                   int theta, int vec, int depth, unsigned grid, int variant,
                   int k, int z, int log2g, void* stream) {
  const ContainsArgs a{static_cast<const uint2*>(keys), nullptr,
                       static_cast<const uint32_t*>(words),
                       static_cast<bool*>(out),
                       static_cast<const uint32_t*>(salts), n, 0u, block_mask,
                       variant, k, z, log2g};
  return contains_entry<false>(s, theta, vec, depth, grid, a,
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
