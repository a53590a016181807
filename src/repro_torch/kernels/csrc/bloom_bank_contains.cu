// bloom_bank_contains: the routed contains of a (B, n_words) bank
// (bloom_contains_kernel, BANK = true), replacing repro/kernels/sbf.py
// bank_contains_vmem. The kernel and its design are in bloom_blocked.cuh
// and bloom.cu; this library holds the bank form's instances, built beside
// bloom.cu's in parallel.

#include "bloom_blocked.cuh"

extern "C" {

// keys: (n, 2) int32 [hi, lo], 8-byte aligned; member: (n,) int32 in
// [0, B); words: the (B, member_words) bank, 16-byte aligned; out: (n,)
// bool; salts: (3, 96) int32; theta, vec, depth, grid as bloom_contains.
int bloom_bank_contains(const void* keys, const void* member,
                        const void* words, void* out, const void* salts,
                        long long n, unsigned long long member_words,
                        unsigned block_mask, int s, int theta, int vec,
                        int depth, unsigned grid, int variant, int k, int z,
                        int log2g, void* stream) {
  const ContainsArgs a{static_cast<const uint2*>(keys),
                       static_cast<const int32_t*>(member),
                       static_cast<const uint32_t*>(words),
                       static_cast<bool*>(out),
                       static_cast<const uint32_t*>(salts), n, member_words,
                       block_mask, variant, k, z, log2g};
  return contains_entry<true>(s, theta, vec, depth, grid, a,
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
