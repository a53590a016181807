// Blocked Bloom filter kernels for Hopper (sm_90a): bulk contains and add
// for the sbf / bbf / rbbf / csbf variants.
//
// Replaces seven Pallas entry points of repro/kernels/sbf.py:
//   bloom_contains_kernel<.., false> <- contains_vmem (_contains_vmem_kernel,
//                            _contains_vmem_gather_kernel,
//                            _contains_vmem_coop_kernel) and contains_hbm
//                            (_contains_hbm_kernel, _contains_hbm_coop_kernel)
//   bloom_add_kernel<S, false>       <- add_vmem (_add_vmem_kernel,
//                            _add_vmem_gather_kernel, _add_vmem_coop_kernel)
//                            and add_hbm (_add_hbm_kernel)
//   bloom_contains_kernel<.., true>  <- bank_contains_vmem
//                            (_bank_contains_vmem_kernel,
//                            _bank_contains_vmem_gather_kernel)
//   bloom_add_kernel<S, true>        <- bank_add_vmem (_bank_add_vmem_kernel,
//                            _bank_add_vmem_gather_kernel)
//   bloom_add_partitioned_kernel<S>  <- add_partitioned
//                            (_add_partitioned_kernel)
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
// Banks (BANK = true). A (B, n_words) bank of same-spec filters is one
// filter of B * n_blocks blocks: key i's block row starts at
// member[i] * member_words + (h_blk & block_mask) * S (64-bit offsets;
// block_mask is one member's n_blocks - 1), so B members take one launch
// and the single-filter design carries over unchanged. The bank add skips
// slots whose valid byte is 0: write padding is the all-zero key routed to
// member 0, a real key. The JAX package has only the VMEM bank kernels and
// sends a bank too large for VMEM to jnp; here the same kernels serve a
// bank in L2 (contains DEPTH = 1) and one in DRAM (DEPTH = depth). Routed
// traffic is often skewed: many keys on one member's words only contend in
// the atomics, and OR stays order-free, so the words stay exact.
//
// Partitioned add (bloom_add_partitioned_kernel<S>). The keys arrive
// bucketed by the filter segment their block falls in: (n_segments,
// capacity) slots with a valid mask, segment i owning words
// [i * seg_words, (i + 1) * seg_words). Each TPU grid step owns one
// segment, which makes its read-modify-writes exclusive. On Hopper the
// same ownership keeps the atomics out of global memory: where a segment
// fits a CTA's shared memory (seg_words * 4 bytes within the opt-in limit,
// 227 KB on the H100), one CTA per segment stages the segment in shared
// memory, ORs its keys' masks in with shared atomicOr at (block * S) mod
// seg_words (as the TPU kernel does, so a key placed in a foreign segment
// lands where it lands there) and writes the segment back: the filter is
// read and written once, in 128-bit transfers. A larger segment runs one
// thread per slot over all segments with global atomicOr at the same
// word, which gives the same words (OR is order-free). Which of the two
// runs is the caller's choice (shared = 1 or 0), a schedule and not a
// result. Invalid slots are skipped. Bound: DRAM bytes (the filter twice,
// the slots' keys and valid bytes) on the shared path; L2 atomics on the
// global one.
//
// Salts (3 x 96 u32: bit salts, bbf word salts, csbf group salts) arrive as
// a device pointer and are staged in shared memory once per CTA. The
// variant, k, z, log2 g and n_blocks - 1 are kernel arguments; S, PHI and
// DEPTH are template parameters so the per-key words and masks live in
// registers.
//
// C interface for ctypes: each entry point returns cudaGetLastError() after
// its launch (or -1 for a shape that has no instantiation). The wrappers
// check every member id against [0, B) before a bank launch.

#include "bloom_common.cuh"

namespace {

// Launch arguments, carried through the host-side dispatch. The kernels
// take them as separate parameters so that the read-only pointers keep
// their __restrict__ (and the loads their read-only path). member and
// member_words are read only by the bank forms; valid (nullable: every key
// valid) only by the add.
struct ContainsArgs {
  const uint2* keys;
  const int32_t* member;
  const uint32_t* words;
  bool* out;
  const uint32_t* salts;
  int64_t n;
  uint64_t member_words;
  uint32_t block_mask;
  int variant, k, z, log2g;
};

struct AddArgs {
  const uint2* keys;
  const int32_t* member;
  const uint8_t* valid;
  uint32_t* words;
  const uint32_t* salts;
  int64_t n;
  uint64_t member_words;
  uint32_t block_mask;
  int variant, k, z, log2g;
};

// First word of key i's block row; a bank adds the member's offset for a
// live key.
template <int S, bool BANK>
__device__ __forceinline__ uint64_t row_start(const int32_t* member,
                                              uint64_t member_words,
                                              int64_t i, bool live,
                                              uint32_t h_blk,
                                              uint32_t block_mask) {
  uint64_t start = uint64_t(h_blk & block_mask) * uint64_t(S);
  if constexpr (BANK) {
    if (live) start += uint64_t(uint32_t(member[i])) * member_words;
  }
  return start;
}

template <int S, int PHI, int DEPTH, bool BANK>
__global__ void __launch_bounds__(kThreads)
    bloom_contains_kernel(const uint2* __restrict__ keys,
                          const int32_t* __restrict__ member,
                          const uint32_t* __restrict__ words,
                          bool* __restrict__ out,
                          const uint32_t* __restrict__ salts, int64_t n,
                          uint64_t member_words, uint32_t block_mask,
                          int variant, int k, int z, int log2g) {
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
        words + row_start<S, BANK>(member, member_words, i, live, h_blk,
                                   block_mask);
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

template <int S, bool BANK>
__global__ void __launch_bounds__(kThreads)
    bloom_add_kernel(const uint2* __restrict__ keys,
                     const int32_t* __restrict__ member,
                     const uint8_t* __restrict__ valid, uint32_t* words,
                     const uint32_t* __restrict__ salts, int64_t n,
                     uint64_t member_words, uint32_t block_mask, int variant,
                     int k, int z, int log2g) {
  __shared__ uint32_t smem[3 * kMaxSalts];
  stage_salts(smem, salts);
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n || (valid != nullptr && valid[i] == 0)) return;
  uint32_t h_pat, h_blk;
  hash_key(keys[i], h_pat, h_blk);
  uint32_t m[S];
  build_mask<S>(m, h_pat, smem, smem + kMaxSalts, smem + 2 * kMaxSalts,
                variant, k, z, log2g);
  uint32_t* row = words + row_start<S, BANK>(member, member_words, i, true,
                                             h_blk, block_mask);
#pragma unroll
  for (int j = 0; j < S; ++j)
    if (m[j]) atomicOr(row + j, m[j]);
}

constexpr int kPartThreads = 512;

template <int S>
__global__ void __launch_bounds__(kPartThreads)
    bloom_add_partitioned_kernel(const uint2* __restrict__ keys,
                                 const uint8_t* __restrict__ valid,
                                 uint32_t* words,
                                 const uint32_t* __restrict__ salts,
                                 int64_t n_slots, int64_t capacity,
                                 uint32_t seg_words, uint32_t block_mask,
                                 int variant, int k, int z, int log2g,
                                 int shared) {
  __shared__ uint32_t smem[3 * kMaxSalts];
  extern __shared__ uint4 seg_smem[];
  stage_salts(smem, salts);
  if (shared) {
    uint32_t* seg = reinterpret_cast<uint32_t*>(seg_smem);
    uint32_t* own = words + uint64_t(blockIdx.x) * seg_words;
    copy_words(seg, own, seg_words);
    __syncthreads();
    const int64_t first = int64_t(blockIdx.x) * capacity;
    for (int64_t i = threadIdx.x; i < capacity; i += blockDim.x) {
      if (valid[first + i] == 0) continue;
      uint32_t h_pat, h_blk;
      hash_key(keys[first + i], h_pat, h_blk);
      uint32_t m[S];
      build_mask<S>(m, h_pat, smem, smem + kMaxSalts, smem + 2 * kMaxSalts,
                    variant, k, z, log2g);
      uint32_t* row = seg + ((h_blk & block_mask) * uint32_t(S)) % seg_words;
#pragma unroll
      for (int j = 0; j < S; ++j)
        if (m[j]) atomicOr(row + j, m[j]);
    }
    __syncthreads();
    copy_words(own, seg, seg_words);
    return;
  }
  const int64_t i = int64_t(blockIdx.x) * kPartThreads + threadIdx.x;
  if (i >= n_slots || valid[i] == 0) return;
  uint32_t h_pat, h_blk;
  hash_key(keys[i], h_pat, h_blk);
  uint32_t m[S];
  build_mask<S>(m, h_pat, smem, smem + kMaxSalts, smem + 2 * kMaxSalts,
                variant, k, z, log2g);
  uint32_t* row = words + uint64_t(i / capacity) * seg_words +
                  ((h_blk & block_mask) * uint32_t(S)) % seg_words;
#pragma unroll
  for (int j = 0; j < S; ++j)
    if (m[j]) atomicOr(row + j, m[j]);
}

struct PartitionedArgs {
  const uint2* keys;
  const uint8_t* valid;
  uint32_t* words;
  const uint32_t* salts;
  int64_t n_segments, capacity;
  uint32_t seg_words, block_mask;
  int variant, k, z, log2g, shared;
};

template <int S>
int launch_partitioned(const PartitionedArgs& a, cudaStream_t stream) {
  const int64_t n_slots = a.n_segments * a.capacity;
  if (a.shared) {
    const size_t bytes = size_t(a.seg_words) * sizeof(uint32_t);
    int dev = 0;
    cudaGetDevice(&dev);
    if (a.seg_words % S || int64_t(bytes) > partition_smem_bytes(dev))
      return -1;
    cudaFuncSetAttribute(bloom_add_partitioned_kernel<S>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         int(bytes));
    bloom_add_partitioned_kernel<S>
        <<<unsigned(a.n_segments), kPartThreads, bytes, stream>>>(
            a.keys, a.valid, a.words, a.salts, n_slots, a.capacity,
            a.seg_words, a.block_mask, a.variant, a.k, a.z, a.log2g, 1);
  } else {
    const unsigned grid =
        unsigned((n_slots + kPartThreads - 1) / kPartThreads);
    bloom_add_partitioned_kernel<S><<<grid, kPartThreads, 0, stream>>>(
        a.keys, a.valid, a.words, a.salts, n_slots, a.capacity, a.seg_words,
        a.block_mask, a.variant, a.k, a.z, a.log2g, 0);
  }
  return int(cudaGetLastError());
}

int partitioned_entry(int s, const PartitionedArgs& a, cudaStream_t st) {
  switch (s) {
    case 1:
      return launch_partitioned<1>(a, st);
    case 2:
      return launch_partitioned<2>(a, st);
    case 4:
      return launch_partitioned<4>(a, st);
    case 8:
      return launch_partitioned<8>(a, st);
    case 16:
      return launch_partitioned<16>(a, st);
    case 32:
      return launch_partitioned<32>(a, st);
  }
  return -1;
}

template <int S, int PHI, int DEPTH, bool BANK>
int launch_contains(const ContainsArgs& a, cudaStream_t stream) {
  const int64_t per_cta = int64_t(kThreads) * DEPTH;
  const unsigned grid = unsigned((a.n + per_cta - 1) / per_cta);
  bloom_contains_kernel<S, PHI, DEPTH, BANK><<<grid, kThreads, 0, stream>>>(
      a.keys, a.member, a.words, a.out, a.salts, a.n, a.member_words,
      a.block_mask, a.variant, a.k, a.z, a.log2g);
  return int(cudaGetLastError());
}

template <int S, int PHI, bool BANK>
int dispatch_depth(int depth, const ContainsArgs& a, cudaStream_t st) {
  // contains_vmem runs DEPTH = 1 at any PHI; contains_hbm runs the widest
  // PHI at any DEPTH, with at most 64 block words in flight per thread
  constexpr bool kDeep = PHI == (S < 4 ? S : 4);
  if (depth > 1 && !kDeep) return -1;
  switch (depth) {
    case 1:
      return launch_contains<S, PHI, 1, BANK>(a, st);
    case 2:
      if constexpr (kDeep && 2 * S <= 64)
        return launch_contains<S, PHI, 2, BANK>(a, st);
      break;
    case 4:
      if constexpr (kDeep && 4 * S <= 64)
        return launch_contains<S, PHI, 4, BANK>(a, st);
      break;
    case 8:
      if constexpr (kDeep && 8 * S <= 64)
        return launch_contains<S, PHI, 8, BANK>(a, st);
      break;
  }
  return -1;
}

template <int S, bool BANK>
int dispatch_phi(int phi, int depth, const ContainsArgs& a, cudaStream_t st) {
  switch (phi) {
    case 1:
      return dispatch_depth<S, 1, BANK>(depth, a, st);
    case 2:
      if constexpr (S >= 2) return dispatch_depth<S, 2, BANK>(depth, a, st);
      break;
    case 4:
      if constexpr (S >= 4) return dispatch_depth<S, 4, BANK>(depth, a, st);
      break;
  }
  return -1;
}

template <bool BANK>
int contains_entry(int s, int phi, int depth, const ContainsArgs& a,
                   cudaStream_t st) {
  switch (s) {
    case 1:
      return dispatch_phi<1, BANK>(phi, depth, a, st);
    case 2:
      return dispatch_phi<2, BANK>(phi, depth, a, st);
    case 4:
      return dispatch_phi<4, BANK>(phi, depth, a, st);
    case 8:
      return dispatch_phi<8, BANK>(phi, depth, a, st);
    case 16:
      return dispatch_phi<16, BANK>(phi, depth, a, st);
    case 32:
      return dispatch_phi<32, BANK>(phi, depth, a, st);
  }
  return -1;
}

template <int S, bool BANK>
int launch_add(const AddArgs& a, cudaStream_t stream) {
  const unsigned grid = unsigned((a.n + kThreads - 1) / kThreads);
  bloom_add_kernel<S, BANK><<<grid, kThreads, 0, stream>>>(
      a.keys, a.member, a.valid, a.words, a.salts, a.n, a.member_words,
      a.block_mask, a.variant, a.k, a.z, a.log2g);
  return int(cudaGetLastError());
}

template <bool BANK>
int add_entry(int s, const AddArgs& a, cudaStream_t st) {
  switch (s) {
    case 1:
      return launch_add<1, BANK>(a, st);
    case 2:
      return launch_add<2, BANK>(a, st);
    case 4:
      return launch_add<4, BANK>(a, st);
    case 8:
      return launch_add<8, BANK>(a, st);
    case 16:
      return launch_add<16, BANK>(a, st);
    case 32:
      return launch_add<32, BANK>(a, st);
  }
  return -1;
}

}  // namespace

extern "C" {

// keys: (n, 2) int32 [hi, lo], 8-byte aligned; words: (n_words,) int32,
// 16-byte aligned; out: (n,) bool; salts: (3, 96) int32.
int bloom_contains(const void* keys, const void* words, void* out,
                   const void* salts, long long n, unsigned block_mask, int s,
                   int phi, int depth, int variant, int k, int z, int log2g,
                   void* stream) {
  const ContainsArgs a{static_cast<const uint2*>(keys), nullptr,
                       static_cast<const uint32_t*>(words),
                       static_cast<bool*>(out),
                       static_cast<const uint32_t*>(salts), n, 0u, block_mask,
                       variant, k, z, log2g};
  return contains_entry<false>(s, phi, depth, a,
                               static_cast<cudaStream_t>(stream));
}

int bloom_add(const void* keys, void* words, const void* salts, long long n,
              unsigned block_mask, int s, int variant, int k, int z,
              int log2g, void* stream) {
  const AddArgs a{static_cast<const uint2*>(keys), nullptr, nullptr,
                  static_cast<uint32_t*>(words),
                  static_cast<const uint32_t*>(salts), n, 0u, block_mask,
                  variant, k, z, log2g};
  return add_entry<false>(s, a, static_cast<cudaStream_t>(stream));
}

// Bank forms. member: (n,) int32 in [0, B); words: the (B, member_words)
// bank, 16-byte aligned; valid: (n,) uint8 or null (every key valid).
int bloom_bank_contains(const void* keys, const void* member,
                        const void* words, void* out, const void* salts,
                        long long n, unsigned long long member_words,
                        unsigned block_mask, int s, int phi, int depth,
                        int variant, int k, int z, int log2g, void* stream) {
  const ContainsArgs a{static_cast<const uint2*>(keys),
                       static_cast<const int32_t*>(member),
                       static_cast<const uint32_t*>(words),
                       static_cast<bool*>(out),
                       static_cast<const uint32_t*>(salts), n, member_words,
                       block_mask, variant, k, z, log2g};
  return contains_entry<true>(s, phi, depth, a,
                              static_cast<cudaStream_t>(stream));
}

int bloom_bank_add(const void* keys, const void* member, const void* valid,
                   void* words, const void* salts, long long n,
                   unsigned long long member_words, unsigned block_mask,
                   int s, int variant, int k, int z, int log2g,
                   void* stream) {
  const AddArgs a{static_cast<const uint2*>(keys),
                  static_cast<const int32_t*>(member),
                  static_cast<const uint8_t*>(valid),
                  static_cast<uint32_t*>(words),
                  static_cast<const uint32_t*>(salts), n, member_words,
                  block_mask, variant, k, z, log2g};
  return add_entry<true>(s, a, static_cast<cudaStream_t>(stream));
}

// Partitioned add. keys: (n_segments, capacity, 2) int32, 8-byte aligned;
// valid: (n_segments, capacity) uint8; words: (n_segments * seg_words,)
// int32, 16-byte aligned; shared: 1 stages each segment in shared memory
// (seg_words * 4 <= bloom_partition_smem()), 0 runs global atomics.
int bloom_add_partitioned(const void* keys, const void* valid, void* words,
                          const void* salts, long long n_segments,
                          long long capacity, unsigned seg_words,
                          unsigned block_mask, int s, int variant, int k,
                          int z, int log2g, int shared, void* stream) {
  if (n_segments <= 0 || capacity <= 0) return 0;
  const PartitionedArgs a{static_cast<const uint2*>(keys),
                          static_cast<const uint8_t*>(valid),
                          static_cast<uint32_t*>(words),
                          static_cast<const uint32_t*>(salts), n_segments,
                          capacity, seg_words, block_mask, variant, k, z,
                          log2g, shared};
  return partitioned_entry(s, a, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory (bytes) a partitioned CTA may take on `device`.
int bloom_partition_smem(int device) { return partition_smem_bytes(device); }

}  // extern "C"
