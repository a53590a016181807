// Blocked Bloom filter kernels for Hopper (sm_90a): bulk contains and add
// for the sbf / bbf / rbbf / csbf variants.
//
// Replaces seven Pallas entry points of repro/kernels/sbf.py:
//   bloom_contains_kernel<.., false> <- contains_vmem (_contains_vmem_kernel,
//                            _contains_vmem_gather_kernel,
//                            _contains_vmem_coop_kernel) and contains_hbm
//                            (_contains_hbm_kernel, _contains_hbm_coop_kernel)
//   bloom_add_kernel<.., false>      <- add_vmem (_add_vmem_kernel,
//                            _add_vmem_gather_kernel, _add_vmem_coop_kernel)
//                            and add_hbm (_add_hbm_kernel)
//   bloom_contains_kernel<.., true>  <- bank_contains_vmem
//                            (_bank_contains_vmem_kernel,
//                            _bank_contains_vmem_gather_kernel)
//   bloom_add_kernel<.., true>       <- bank_add_vmem (_bank_add_vmem_kernel,
//                            _bank_add_vmem_gather_kernel)
//   bloom_add_partitioned_global_kernel<S, THETA> or
//   bloom_add_partitioned_shared_kernel<S>
//                                    <- add_partitioned
//                            (_add_partitioned_kernel)
//
// Design. A TPU core must either pin the filter in VMEM or stream blocks
// through a DMA ring, and it has no atomics, so the Pallas kernels sort each
// tile by block and own every read-modify-write. Hopper needs neither split:
// the L2 holds a filter up to its size, and L2 atomics make an unordered
// insert exact. What Hopper does charge for is the number of memory
// requests: a warp-wide instruction whose 32 lanes address 32 unrelated
// blocks becomes 32 requests to the L2, however few bytes each lane wants.
//
// Warp cooperation (the paper's (Θ, Φ) layout). A group of THETA adjacent
// lanes owns one key at a time; lane j of the group owns the W = S / THETA
// contiguous words [j * W, (j + 1) * W) of the key's block and moves them V
// words at a time (V <= 4: a 128-bit load is Hopper's widest). THETA
// divides 32, so a group never straddles a warp. A warp loads 32
// consecutive keys, one a lane, and hashes them, one key a lane (both xxh32
// streams share the lane products, which is mix="cheap"; the result is the
// same as mix="full"). It then walks them in rounds: in each round every
// group takes one key's pattern hash and block row from the lane that
// hashed it, by __shfl_sync, and each lane builds only its own words of the
// mask (build_mask_part). Every lane stays alive up to the last
// collective: a ragged tail, a dead slot or an invalid bank slot is masked,
// never returned early; only a warp whose first key lies past n leaves, as
// a whole. THETA = 1 is one thread a key, the first design's loop kept as
// it was (whole mask by build_mask, a thread returning early, and for the
// contains a key left at its first load that misses): it has no
// collective, and it is the yardstick each THETA is timed against.
//
// * bloom_add_kernel<S, THETA, BANK>: lane j issues atomicOr on each
//   nonzero word it owns (the result is unused, so it compiles to RED). The
//   lanes of a group address consecutive words of one block, so one warp
//   instruction reaches the L2 as 32 / THETA sector requests instead of 32.
//   OR commutes and is idempotent, so the words equal the sequential
//   reference bit for bit in any lane order. Bound: L2 atomic requests, in
//   both regimes (atomics execute in the L2; in DRAM each touched sector is
//   also read from and written back to DRAM). THETA = S makes each key one
//   request of one sector.
// * bloom_contains_kernel<S, THETA, V, DEPTH, BANK>: a group keeps DEPTH
//   keys in flight: each lane issues its V-word loads for DEPTH keys before
//   it tests any of them, which takes the place of contains_hbm's DMA ring
//   (at most MAX_WORDS_IN_FLIGHT = 64 words a lane, DEPTH * W <= 64). A
//   group decides a key by a __ballot_sync over its lanes' miss flags; the
//   lane that hashed the key keeps the result, and the warp writes its 32
//   result bytes together. Bound: in DRAM, random 32-byte sectors (one a key
//   for B = 256; the practical bound is keys + results + one sector a key at
//   the DRAM rate); THETA = S / 4 with V = 4 reads a B = 256 block as two
//   lanes' 16-byte loads of one instruction, whole sectors, where THETA = 1
//   needs two instructions that each touch 32 half-used sectors. In L2, L2
//   requests and integer issue (~100 integer ops a key for k = 16), where
//   THETA > 1 adds shuffles and a ballot a round.
//
// The wrappers (kernels/sbf.py launch_geometry) resolve THETA, V, DEPTH and
// the grid; a layout the caller passes acts as given, else the card's rule
// (sbf.card_layout) decides. The two templates live in bloom_blocked.cuh:
// this library instantiates the add, bloom_contains.cu and
// bloom_bank_contains.cu the two forms of the contains (most of the
// instances), so that their builds run in parallel.
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
// Partitioned add. The keys arrive bucketed by the filter segment their
// block falls in: (n_segments, capacity) slots with a valid mask, segment i
// owning words [i * seg_words, (i + 1) * seg_words). A valid slot held by
// segment i ORs its mask at i * seg_words + (block * S) mod seg_words, as
// the TPU kernel does (a key bucketed into a foreign segment lands where it
// lands there). OR is order-free and idempotent, so any schedule that ORs
// each valid slot once at that word gives the TPU kernel's words. The
// partition leaves ~3/4 of the slots invalid (capacity is 4x the mean), and
// each TPU grid step owns one segment. Two schedules, picked by the wrapper
// (sbf.choose_partitioned_path), neither changing a result:
//
// * bloom_add_partitioned_global_kernel<S, THETA> (global red.or): a CTA
//   takes 256 consecutive slots, a warp 32, and reads their valid bytes
//   first; a CTA with no valid slot leaves before it stages the salts (the
//   partition's invalid tails fill whole CTAs), and so does a warp of 32
//   invalid slots. Each valid lane hashes its key and queues (pattern hash, row word) in the warp's
//   slice of shared memory at its rank among the valid lanes
//   (__ballot_sync), then groups of THETA lanes take the queued keys in rounds, each lane
//   building only its own W = S / THETA words of the mask
//   (build_mask_part) and issuing atomicOr (RED) on each nonzero word it
//   owns: a key leaves the warp as one sector request at THETA = S (the
//   blocked add's schedule, bloom_add_kernel), not S. A kernel of its own
//   rather than a partitioned form of bloom_add_kernel: the compaction of a
//   mostly invalid warp and the per-slot segment base are this path's, and
//   bloom_blocked.cuh (rows 1-6) stays as it is. Bound: L2 atomic requests,
//   one a key at THETA = S (in DRAM each touched sector is also read and
//   written back), plus the valid bytes.
// * bloom_add_partitioned_shared_kernel<S> (shared memory, no global
//   atomics): one CTA a segment. It starts its segment's copy into shared
//   memory with 16-byte cp.async (no registers staged), then walks the
//   segment's slots a thread each (a warp skips a round whose 32 slots are
//   all invalid), applies each valid key with shared atomicOr, and writes
//   the segment back in 128-bit stores where a key touched it. The wrapper's
//   rule sends it only segments of at most 32 KiB in L2, where several CTAs
//   share an SM and their copies overlap the others' atomics. R CTAs a
//   segment (each owning seg_words / R words and hashing every key R times)
//   lost to this and to the global path at every swept count (PERF.md, row
//   7). Bound: the touched segments read and written once, the valid bytes
//   and the valid keys' 8 B once.
//
// Salts (3 x 96 u32: bit salts, bbf word salts, csbf group salts) arrive as
// a device pointer and are staged in shared memory once per CTA. The
// variant, k, z, log2 g and n_blocks - 1 are kernel arguments; S, THETA, V
// and DEPTH are template parameters so the per-lane words and masks live in
// registers.
//
// C interface for ctypes: each entry point returns cudaGetLastError() after
// its launch (or -1 for a shape that has no instantiation, or a grid too
// small for n). The wrappers check every member id against [0, B) before a
// bank launch.

#include "bloom_blocked.cuh"

namespace {

constexpr int kPartThreads = 512;      // the shared path's CTA

// Start a 16-byte copy from global to shared memory (cp.async, L2 only).
__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// (x * S) mod seg_words: a mask where seg_words is a power of two (every
// partition ops makes), else a division.
__device__ __forceinline__ uint32_t seg_offset(uint32_t x, uint32_t seg_words) {
  return (seg_words & (seg_words - 1u)) == 0u ? x & (seg_words - 1u)
                                               : x % seg_words;
}

template <int S, int THETA>
__global__ void __launch_bounds__(kThreads)
    bloom_add_partitioned_global_kernel(const uint2* __restrict__ keys,
                                        const uint8_t* __restrict__ valid,
                                        uint32_t* words,
                                        const uint32_t* __restrict__ salts,
                                        uint32_t n_slots, uint32_t capacity,
                                        uint32_t seg_words,
                                        uint32_t block_mask, int variant,
                                        int k, int z, int log2g) {
  constexpr int W = S / THETA;                      // words a lane owns
  constexpr int kGroups = 32 / THETA;
  static_assert(32 % THETA == 0 && S % THETA == 0, "THETA divides 32 and S");
  __shared__ uint32_t smem[3 * kMaxSalts];
  __shared__ uint32_t queue[kWarps][2][32];         // pattern hash, row word
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n_slots && valid[i] != 0;
  if (!__syncthreads_or(live)) return;    // no valid slot: no salts staged
  stage_salts(smem, salts);
  const unsigned lanes = __ballot_sync(kFullWarp, live);
  if (lanes == 0u) return;                          // 32 invalid slots
  if (live) {
    uint32_t h_pat, h_blk;
    hash_key(keys[i], h_pat, h_blk);
    const int rank = __popc(lanes & ((1u << lane) - 1u));
    queue[warp][0][rank] = h_pat;
    queue[warp][1][rank] =
        (i / capacity) * seg_words +
        seg_offset((h_blk & block_mask) * uint32_t(S), seg_words);
  }
  __syncwarp();
  const int j = lane % THETA;
  const int queued = __popc(lanes);
  for (int q = lane / THETA; q < queued; q += kGroups) {
    uint32_t m[W];
    build_mask_part<S, W>(m, queue[warp][0][q], j * W, smem,
                          smem + kMaxSalts, smem + 2 * kMaxSalts, variant, k,
                          z, log2g);
    uint32_t* dst = words + queue[warp][1][q] + j * W;
#pragma unroll
    for (int t = 0; t < W; ++t)
      if (m[t]) atomicOr(dst + t, m[t]);
  }
}

template <int S>
__global__ void __launch_bounds__(kPartThreads)
    bloom_add_partitioned_shared_kernel(const uint2* __restrict__ keys,
                                        const uint8_t* __restrict__ valid,
                                        uint32_t* words,
                                        const uint32_t* __restrict__ salts,
                                        uint32_t capacity, uint32_t seg_words,
                                        uint32_t block_mask, int variant,
                                        int k, int z, int log2g) {
  __shared__ uint32_t smem[3 * kMaxSalts];
  extern __shared__ uint4 seg_smem[];
  uint32_t* staged = reinterpret_cast<uint32_t*>(seg_smem);
  const uint32_t seg = blockIdx.x;
  uint32_t* own = words + size_t(seg) * seg_words;
  // the segment's copy in flight first (seg_words % 4 == 0, words 16-byte
  // aligned: the wrapper checks both); the salts load beside it
  for (uint32_t w = threadIdx.x; w < seg_words / 4; w += blockDim.x)
    copy_async16(seg_smem + w, reinterpret_cast<const uint4*>(own) + w);
  for (int w = threadIdx.x; w < 3 * kMaxSalts; w += blockDim.x)
    smem[w] = salts[w];
  const uint2* seg_keys = keys + size_t(seg) * capacity;
  const uint8_t* seg_valid = valid + size_t(seg) * capacity;
  copy_async_wait_all();
  __syncthreads();
  bool touched = false;
  const uint32_t rounds = (capacity + blockDim.x - 1) / blockDim.x;
  for (uint32_t r = 0, i = threadIdx.x; r < rounds; ++r, i += blockDim.x) {
    const bool live = i < capacity && seg_valid[i] != 0;
    if (__ballot_sync(kFullWarp, live) == 0u || !live) continue;
    uint32_t h_pat, h_blk;
    hash_key(seg_keys[i], h_pat, h_blk);
    const uint32_t off =
        seg_offset((h_blk & block_mask) * uint32_t(S), seg_words);
    uint32_t m[S];
    build_mask<S>(m, h_pat, smem, smem + kMaxSalts, smem + 2 * kMaxSalts,
                  variant, k, z, log2g);
#pragma unroll
    for (int t = 0; t < S; ++t)
      if (m[t]) atomicOr(staged + off + t, m[t]);
    touched = true;
  }
  if (__syncthreads_or(touched)) {
    uint4* dst = reinterpret_cast<uint4*>(own);
    for (uint32_t w = threadIdx.x; w < seg_words / 4; w += blockDim.x)
      dst[w] = seg_smem[w];
  }
}

struct PartitionedArgs {
  const uint2* keys;
  const uint8_t* valid;
  uint32_t* words;
  const uint32_t* salts;
  int64_t n_segments, capacity;
  uint32_t seg_words, block_mask;
  int variant, k, z, log2g, theta;
  bool shared;
};

template <int S, int THETA>
int launch_partitioned_global(const PartitionedArgs& a, cudaStream_t st) {
  const int64_t n_slots = a.n_segments * a.capacity;
  const unsigned grid = unsigned((n_slots + kThreads - 1) / kThreads);
  bloom_add_partitioned_global_kernel<S, THETA><<<grid, kThreads, 0, st>>>(
      a.keys, a.valid, a.words, a.salts, uint32_t(n_slots),
      uint32_t(a.capacity), a.seg_words, a.block_mask, a.variant, a.k, a.z,
      a.log2g);
  return int(cudaGetLastError());
}

// shared: one CTA a segment, the segment a whole number of rows and of
// 16-byte vectors within the card's budget; else the global path at THETA lanes a key.
template <int S>
int launch_partitioned(const PartitionedArgs& a, cudaStream_t st) {
  if (a.n_segments * a.capacity >= (1LL << 32)) return -1;  // u32 slots
  if (a.shared) {
    const size_t bytes = size_t(a.seg_words) * sizeof(uint32_t);
    int dev = 0;
    cudaGetDevice(&dev);
    if (a.seg_words % S || a.seg_words % 4 ||
        int64_t(bytes) > partition_smem_bytes(dev) ||
        a.n_segments >= (1LL << 31))
      return -1;
    cudaFuncSetAttribute(bloom_add_partitioned_shared_kernel<S>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         int(bytes));
    bloom_add_partitioned_shared_kernel<S>
        <<<unsigned(a.n_segments), kPartThreads, bytes, st>>>(
            a.keys, a.valid, a.words, a.salts, uint32_t(a.capacity),
            a.seg_words, a.block_mask, a.variant, a.k, a.z, a.log2g);
    return int(cudaGetLastError());
  }
  switch (a.theta) {
    case 1:
      return launch_partitioned_global<S, 1>(a, st);
    case 2:
      if constexpr (S >= 2) return launch_partitioned_global<S, 2>(a, st);
      break;
    case 4:
      if constexpr (S >= 4) return launch_partitioned_global<S, 4>(a, st);
      break;
    case 8:
      if constexpr (S >= 8) return launch_partitioned_global<S, 8>(a, st);
      break;
    case 16:
      if constexpr (S >= 16) return launch_partitioned_global<S, 16>(a, st);
      break;
    case 32:
      if constexpr (S >= 32) return launch_partitioned_global<S, 32>(a, st);
      break;
  }
  return -1;
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

}  // namespace

extern "C" {

// keys: (n, 2) int32 [hi, lo], 8-byte aligned; words: (n_words,) int32,
// 16-byte aligned; salts: (3, 96) int32. theta: lanes a key; grid: CTAs
// (sbf.launch_geometry).
int bloom_add(const void* keys, void* words, const void* salts, long long n,
              unsigned block_mask, int s, int theta, unsigned grid,
              int variant, int k, int z, int log2g, void* stream) {
  const AddArgs a{static_cast<const uint2*>(keys), nullptr, nullptr,
                  static_cast<uint32_t*>(words),
                  static_cast<const uint32_t*>(salts), n, 0u, block_mask,
                  variant, k, z, log2g};
  return add_entry<false>(s, theta, grid, a,
                          static_cast<cudaStream_t>(stream));
}

// Bank form. member: (n,) int32 in [0, B); words: the (B, member_words)
// bank, 16-byte aligned; valid: (n,) uint8 or null (every key valid).
int bloom_bank_add(const void* keys, const void* member, const void* valid,
                   void* words, const void* salts, long long n,
                   unsigned long long member_words, unsigned block_mask,
                   int s, int theta, unsigned grid, int variant, int k, int z,
                   int log2g, void* stream) {
  const AddArgs a{static_cast<const uint2*>(keys),
                  static_cast<const int32_t*>(member),
                  static_cast<const uint8_t*>(valid),
                  static_cast<uint32_t*>(words),
                  static_cast<const uint32_t*>(salts), n, member_words,
                  block_mask, variant, k, z, log2g};
  return add_entry<true>(s, theta, grid, a,
                         static_cast<cudaStream_t>(stream));
}

// Partitioned add. keys: (n_segments, capacity, 2) int32, 8-byte aligned;
// valid: (n_segments, capacity) uint8; words: (n_segments * seg_words,)
// int32, 16-byte aligned; shared: nonzero for the shared path, one CTA a
// segment (seg_words * 4 <= bloom_partition_smem()), 0 for the global path
// at theta lanes a key.
int bloom_add_partitioned(const void* keys, const void* valid, void* words,
                          const void* salts, long long n_segments,
                          long long capacity, unsigned seg_words,
                          unsigned block_mask, int s, int theta, int variant,
                          int k, int z, int log2g, int shared, void* stream) {
  if (n_segments <= 0 || capacity <= 0) return 0;
  const PartitionedArgs a{static_cast<const uint2*>(keys),
                          static_cast<const uint8_t*>(valid),
                          static_cast<uint32_t*>(words),
                          static_cast<const uint32_t*>(salts), n_segments,
                          capacity, seg_words, block_mask, variant, k, z,
                          log2g, theta, shared != 0};
  return partitioned_entry(s, a, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory (bytes) a partitioned CTA may take on `device`.
int bloom_partition_smem(int device) { return partition_smem_bytes(device); }

// cudaLimitMaxL2FetchGranularity of `device` in bytes (-1 on an error),
// read with `device` current and the caller's device restored. The library
// sets no limit.
int bloom_l2_fetch_granularity(int device) {
  int current = 0;
  if (cudaGetDevice(&current) != cudaSuccess) return -1;
  size_t value = 0;
  const bool ok = cudaSetDevice(device) == cudaSuccess &&
                  cudaDeviceGetLimit(&value,
                                     cudaLimitMaxL2FetchGranularity) ==
                      cudaSuccess;
  if (cudaSetDevice(current) != cudaSuccess || !ok) return -1;
  return int(value);
}

}  // extern "C"
