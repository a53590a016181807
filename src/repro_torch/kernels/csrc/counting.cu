// Counting Bloom filter kernels for Hopper (sm_90a): bulk update of packed
// 4-bit counters (saturating increment, guarded decrement), the decay pass
// and the partitioned update, for the countingbf variant. The contains (both
// forms) is in counting_contains.cu; both include counting_common.cuh.
//
// Replaces six Pallas entry points of repro/kernels/countingbf.py:
//   counting_update_kernel (one pass) or the binned update's
//   counting_bin_*_kernel        <- update_vmem (_update_vmem_kernel,
//                                   _update_vmem_gather_kernel,
//                                   _update_vmem_coop_kernel), update_hbm
//                                   (_update_hbm_kernel) and
//                                   bank_update_vmem (_bank_update_vmem_kernel,
//                                   _bank_update_vmem_gather_kernel)
//   counting_decay_kernel        <- decay (_decay_kernel)
//   counting_partitioned_grouped_kernel<S, OP> and
//   counting_partitioned_global_kernel<S, OP> <- update_partitioned
//                                   (_update_partitioned_kernel)
//
// Layout. Logical bit i of the sbf-placed mask owns nibble i of the flat
// counter array: logical word j of a block is counter words 4j..4j+3 (one
// aligned 16-byte group), byte c of the mask word goes to counter word
// 4j+c, bit b of that byte to nibble b. A key's row is its block's 4S words.
//
// Design. The TPU has no atomics, so its kernels sort each tile by counter
// row and own every read-modify-write. Hopper has 32-bit atomics but none
// of 4 bits, and atomicAdd would carry out of a nibble at 15 into its
// neighbour. Every update below rests on one fact: within one launch every
// counter moves one way, and the two updates have closed forms that are
// order-free per nibble, min(old + c, 15) for add and old == 15 ? 15 :
// max(old - c, 0) for remove (c, the nibble's increments, capped at 15),
// and two chunks' closed forms compose to the closed form of their sum. So
// any schedule that applies the right per-nibble counts gives the
// sequential reference's words bit for bit.
//
// * The one-pass update, counting_update_kernel<S, OP, BANK> (small
//   batches, hot rows): a warp takes 32 keys, each lane hashes one (invalid
//   slots and lanes past n are dead), and the warp walks them with
//   min(4S, 32) lanes a key, a lane a counter word of the row, sharing each
//   key's hash and row by shuffle. A lane builds only its word's nibble
//   increments (nibble_inc) and, where they are nonzero, loads the word (the
//   key's loads one coalesced row request) and runs the sat_inc_word /
//   guard_dec_word CAS loop from the loaded value; a group issues the loads
//   of two keys' rows before it runs their CAS loops. A loop stops as soon
//   as the update would not change the word: a saturated (add) or 0 / 15
//   (remove) nibble seen once stays so. Measured on the H100 (PERF.md):
//   one key's row in flight, and a lane a logical word (one 16-byte
//   load, up to 4 CAS loops), were 9-40 % slower. Bound: the L2's atomic
//   throughput on the touched words; in DRAM each touched sector is also
//   fetched. It replaces one thread a key with a __ldcg and a CAS loop per
//   nonzero mask byte (8 uncoalesced 16-byte groups of one row a key: 27.59
//   ms for 2^26 keys into 512 MiB).
// * The binned update, no atomics on counters but in over-full bins (large
//   batches into DRAM-resident counters and banks): a bin is 2^b
//   consecutive global rows (a bank's global row is member * n_blocks +
//   block); a key's slot is 8 bytes, (its row within the bin << 32) | its
//   pattern hash. Per internal batch of at most `batch` keys, three to seven
//   kernels on the caller's stream:
//   1. counting_bin_count_kernel: one CTA a chunk of the batch's keys
//      counts its valid keys by bin in shared memory;
//   2. bin_column_kernel: each bin's per-chunk runs, padded to a 32-byte
//      sector (4 slots);
//   3. bin_scan_kernel: one CTA scans the <= 8192 bin lengths (both shared
//      with cbf.cu through bin_common.cuh). For at most kBinThreads bins
//      (batches near the path rule's smallest, whose binned call is partly
//      host-bound) the count kernel's last CTA does 2 and 3 (column_scan,
//      a stream's arrival counter), so neither is launched, and 6 too;
//   4. counting_bin_scatter_kernel: each chunk writes its keys' slots into
//      their runs, each bin's open sector staged in shared memory and
//      written whole (as in cbf.cu: a sector has to leave the SM whole),
//      4096 bins a pass over the chunk; padding is all ones;
//   5. counting_bin_apply_kernel<S, OP>: one CTA a bin of at most
//      kSplitSlots slots (4 chunks; every bin of uniform keys: a bin's rows
//      are chosen so that its keys are about half a chunk at the batch's
//      load, kernels/countingbf.py binned_bin_row_bits) takes its slots in
//      chunks of kApplyChunk, counting-sorts each chunk by row in shared
//      memory and updates each touched row once with the closed forms
//      (update_sorted_rows, the grouped partitioned kernel's row update).
//      Bins are disjoint, so its rows are stored plainly, read and written
//      once a chunk. Staging a bin's rows in shared memory across its
//      chunks was 6-23 % slower (PERF.md);
//   6. counting_bin_parts_kernel (where a bin can pass kSplitSlots and a
//      bin's rows' counts fit shared memory beside a chunk): one CTA cuts
//      each larger bin's run into parts of kPartSlots and scans them;
//   7. counting_bin_split_kernel<S, OP> (likewise): the parts of those
//      over-full bins (skewed keys: a bank's hot member, a key repeated
//      many times) run on the card's CTAs at once. A part sums its chunks'
//      counts per row in shared memory (the row update's add form on
//      zeroed words), then applies each touched counter word's closed form
//      once by CAS: a CAS a word a part, not one a key; the forms compose,
//      so the parts' order is free. Where the counts do not fit, an
//      over-full bin stays one CTA's. Parts that applied each chunk by CAS
//      were up to 8x slower than one CTA a bin on bins just past a part,
//      so only bins past 4 chunks are split, and a part sums first
//      (PERF.md).
//   Bound: the keys read twice, the slots written and read once, each
//   touched row read and written once a chunk.
// * counting_decay_kernel: a grid-stride pass of w - nib_nonzero(w) with
//   128-bit loads and stores. Bound: DRAM bytes (every counter read and
//   written once). A whole bank decays with one launch over its flat words.
//
// * The partitioned update: the keys arrive bucketed by counter segment,
//   (n_segments, capacity) slots with a valid mask, segment i owning
//   counter words [i * seg_cwords, (i + 1) * seg_cwords); a slot's key
//   updates the row at (block * 4S) mod seg_cwords of its segment (the TPU
//   kernel's offset). Invalid slots are skipped. Two paths, which give the
//   same counters; the caller picks one (kernels/countingbf.py
//   choose_partitioned_path):
//   - counting_partitioned_grouped_kernel<S, OP> (path 1, no atomics on
//     counters): one CTA a segment walks its slots in chunks of
//     kGroupChunk. It hashes each valid key once, keeps (row in segment,
//     h_pat) in registers, counting-sorts the chunk by row in shared
//     memory (a histogram of the segment's rows, its scan, a scatter of
//     h_pat), then gives each touched row one group of S lanes, a lane a
//     logical word: the group loads the row's 4S words once (a lane's 4
//     counter words one 16-byte load, coalesced with its neighbours'; two
//     neighbouring rows in flight before either is updated), each lane
//     computes only its word's bits of each key (a quarter of the work of
//     a lane a counter word, where 3 of 4 lanes got no increment) and
//     sums over the row's keys the 0/1 increments of its 32 nibbles (in
//     the nibbles themselves for up to 15 keys, folded into a per-nibble
//     saturating count: min(c, 15) gives both closed forms the same
//     nibble), applies the closed forms once with plain integer operations
//     on the even and odd nibbles as bytes, and stores the row once. Chunks
//     of one segment run in order in one CTA, so a row that spans chunks
//     is exact.
//     Shared memory is the key buffer and the row histogram, 4 (rows +
//     kGroupChunk) bytes (at most 48 KiB), not the segment: two CTAs fit
//     an SM. Bound: the keys and valid bytes read once, each touched row
//     read and written once a chunk.
//   - counting_partitioned_global_kernel<S, OP> (path 0): where a
//     segment's rows do not fit the histogram (few, large segments: JAX's
//     default n_segments = 8) or too few segments fill the card. A warp
//     takes 32 slots; each lane hashes one, and the warp walks them with
//     min(4S, 32) lanes a key, a lane a counter word (32 / L keys at
//     once), sharing each key's hash by shuffle; a lane whose mask byte is
//     nonzero runs the CAS loop on its word. Bound: L2 atomic throughput
//     on the touched words.
//
// C interface for ctypes: each entry point returns cudaGetLastError() after
// its launches (0 for n == 0: nothing launched), or -1 for a shape that has
// no instantiation. The wrappers check every member id against [0, B)
// before a bank launch.

#include <map>
#include <mutex>
#include <tuple>

#include "bin_common.cuh"
#include "counting_common.cuh"

namespace {

__device__ __forceinline__ uint32_t sat_inc_word(uint32_t w, uint32_t inc) {
  return w + (inc & ~nib_saturated(w));
}

__device__ __forceinline__ uint32_t guard_dec_word(uint32_t w, uint32_t dec) {
  return w - (dec & nib_nonzero(w) & ~nib_saturated(w));
}

// The nibble increments one key makes in counter word `word` of its row:
// byte word & 3 of logical word word >> 2 of its sbf-placed mask, bit b of
// the byte as nibble b = 1.
template <int S>
__device__ __forceinline__ uint32_t nibble_inc(uint32_t h, int word,
                                               const uint32_t* salt, int k) {
  const uint32_t c = uint32_t(word & 3);
  uint32_t inc = 0u;
  for (int r = word >> 2; r < k; r += S) {
    const uint32_t b = (h * salt[r]) >> 27;
    if ((b >> 3) == c) inc |= 1u << (4u * (b & 7u));
  }
  return inc;
}

// Per nibble min(a + b, 15) of two words of nibbles: the even and the odd
// nibbles as bytes (at most 30 each), a byte of 16 or more set to 15.
__device__ __forceinline__ uint32_t sat_add_nibbles(uint32_t a, uint32_t b) {
  constexpr uint32_t kLow = 0x0F0F0F0Fu, kB4 = 0x10101010u;
  uint32_t e = (a & kLow) + (b & kLow);
  uint32_t o = ((a >> 4) & kLow) + ((b >> 4) & kLow);
  e |= ((e & kB4) >> 4) * 0x0Fu;
  o |= ((o & kB4) >> 4) * 0x0Fu;
  return (e & kLow) | ((o & kLow) << 4);
}

// The closed forms of a launch's updates of one counter word from the
// per-nibble counts capped at 15 (min(c, 15) gives both forms the same
// nibble): min(old + c, 15) for add; old == 15 ? 15 : max(old - c, 0) for
// remove (16 + old - c as a byte, at least 16 where it is not negative).
template <int OP>
__device__ __forceinline__ uint32_t apply_counts(uint32_t w, uint32_t c) {
  if (OP == kAdd) return sat_add_nibbles(w, c);
  constexpr uint32_t kLow = 0x0F0F0F0Fu, kB4 = 0x10101010u;
  uint32_t e = ((w & kLow) | kB4) - (c & kLow);
  uint32_t o = (((w >> 4) & kLow) | kB4) - ((c >> 4) & kLow);
  e &= ((e & kB4) >> 4) * 0x0Fu;
  o &= ((o & kB4) >> 4) * 0x0Fu;
  return ((e & kLow) | ((o & kLow) << 4)) | (nib_saturated(w) * 0xFu);
}

// The order-free CAS loop of one counter word from a value read before it.
template <int OP>
__device__ __forceinline__ void cas_from(uint32_t* p, uint32_t cur,
                                         uint32_t inc) {
  while (true) {
    const uint32_t next =
        OP == kAdd ? sat_inc_word(cur, inc) : guard_dec_word(cur, inc);
    if (next == cur) break;
    const uint32_t seen = atomicCAS(p, cur, next);
    if (seen == cur) break;
    cur = seen;
  }
}

template <int OP>
__device__ __forceinline__ void cas_word(uint32_t* p, uint32_t inc) {
  cas_from<OP>(p, __ldcg(p), inc);
}

// The closed form of counts c (capped at 15) applied to one counter word by
// a CAS loop from a value read before it: rows that several CTAs update.
// Closed forms compose, so the CTAs' order is free.
template <int OP>
__device__ __forceinline__ void cas_counts(uint32_t* p, uint32_t cur,
                                           uint32_t c) {
  while (c != 0u) {
    const uint32_t next = apply_counts<OP>(cur, c);
    if (next == cur) break;
    const uint32_t seen = atomicCAS(p, cur, next);
    if (seen == cur) break;
    cur = seen;
  }
}

// ---------------------------------------------------------------------------
// The one-pass update
// ---------------------------------------------------------------------------

// The lanes of the one-pass update and the global partitioned kernel: a
// lane a counter word of the row (L lanes a row, W words a lane, G rows a
// warp at once).
template <int S>
struct RowLanes {
  static constexpr int L = 4 * S < 32 ? 4 * S : 32;
  static constexpr int W = 4 * S / L;
  static constexpr int G = 32 / L;
};

constexpr int kOnePassInFlight = 2;     // groups of G keys loaded at once

template <int S, int OP, bool BANK>
__global__ void __launch_bounds__(kThreads)
    counting_update_kernel(const uint2* __restrict__ keys,
                           const int32_t* __restrict__ member,
                           const uint8_t* __restrict__ valid,
                           uint32_t* counters,
                           const uint32_t* __restrict__ salts, int64_t n,
                           uint64_t member_words, uint32_t block_mask, int k) {
  using R = RowLanes<S>;
  constexpr int U = kOnePassInFlight;
  __shared__ uint32_t salt[kMaxSalts];
  for (int t = threadIdx.x; t < kMaxSalts; t += blockDim.x) salt[t] = salts[t];
  __syncthreads();
  const int lane = threadIdx.x & 31, gl = lane % R::L, grp = lane / R::L;
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = i < n && (valid == nullptr || valid[i] != 0);
  uint32_t h_pat = 0u;
  uint64_t start = 0u;
  if (live) {
    uint32_t h_blk;
    hash_key(keys[i], h_pat, h_blk);
    start = counter_row<S, BANK>(h_blk & block_mask,
                                 BANK ? uint32_t(member[i]) : 0u,
                                 member_words);
  }
  const uint32_t live_mask = __ballot_sync(kFullWarp, live);
  if (live_mask == 0u) return;                  // the whole warp
  for (int t0 = 0; t0 < 32; t0 += R::G * U) {
    uint32_t inc[U][R::W], cur[U][R::W];
    uint32_t* row[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {               // increments and loads
      const int src = t0 + u * R::G + grp;
      const uint32_t h = __shfl_sync(kFullWarp, h_pat, src);
      const uint64_t r = __shfl_sync(kFullWarp, start, src);
      const bool on = ((live_mask >> src) & 1u) != 0u;
      row[u] = counters + r;
#pragma unroll
      for (int t = 0; t < R::W; ++t) {
        const int word = gl + R::L * t;
        inc[u][t] = on ? nibble_inc<S>(h, word, salt, k) : 0u;
        if (inc[u][t] != 0u) cur[u][t] = __ldcg(row[u] + word);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {               // the CAS loops
#pragma unroll
      for (int t = 0; t < R::W; ++t) {
        if (inc[u][t] != 0u)
          cas_from<OP>(row[u] + gl + R::L * t, cur[u][t], inc[u][t]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The row update shared by the grouped partitioned kernel and the binned
// apply
// ---------------------------------------------------------------------------

// The grouped kernels' lanes: a lane a logical word of the row, its 4
// counter words one 16-byte load (S lanes a row, G rows a warp at once),
// and U rows a group loads before it updates them.
template <int S>
struct GroupLanes {
  static constexpr int G = 32 / S;
  static constexpr int U = 2;
};

constexpr int kPartThreads = 512;
constexpr int kGroupThreads = 512;
constexpr int kGroupPer = 8;                            // slots a thread
constexpr int kGroupChunk = kGroupThreads * kGroupPer;  // a chunk's slots
constexpr int kMaxGroupRows = 8192;                     // 32 KiB histogram
constexpr uint32_t kNoRow = 0xFFFFFFFFu;

// Exclusive scan of a[0, n) in place by the CTA (n <= 16 x blockDim);
// sums: 32 words of shared scratch. Ends on a barrier.
__device__ __forceinline__ void block_exclusive_scan(uint32_t* a, int n,
                                                     uint32_t* sums) {
  const int per = (n + int(blockDim.x) - 1) / int(blockDim.x);
  const int first = int(threadIdx.x) * per;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t local = 0u;
  for (int j = 0; j < per; ++j)
    if (first + j < n) local += a[first + j];
  uint32_t incl = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < int(blockDim.x >> 5) ? sums[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    sums[lane] = w;
  }
  __syncthreads();
  uint32_t run = incl - local + (warp > 0 ? sums[warp - 1] : 0u);
  for (int j = 0; j < per; ++j) {
    if (first + j < n) {
      const uint32_t v = a[first + j];
      a[first + j] = run;
      run += v;
    }
  }
  __syncthreads();
}

// A chunk counting-sorted by row: hist[r] is the end of row r's run of
// patterns in spat, hist[r - 1] its start. Each touched row of `own` (4S
// words a row, in global or shared memory) is updated once with the closed
// forms by a group of S lanes of a kGroupThreads CTA, a lane a logical
// word; a group takes U neighbouring rows at a time and loads all their
// words before it updates them (U row requests in flight, not one).
template <int S, int OP>
__device__ __forceinline__ void update_sorted_rows(uint32_t* own,
                                                   const uint32_t* hist,
                                                   const uint32_t* spat,
                                                   uint32_t rows,
                                                   const uint32_t* salt,
                                                   int k) {
  using R = GroupLanes<S>;
  constexpr int kGroups = kGroupThreads / 32 * R::G;
  const int lane = threadIdx.x & 31, gl = lane % S;
  const int group = int(threadIdx.x >> 5) * R::G + lane / S;
  for (uint32_t r0 = uint32_t(group) * R::U; r0 < rows;
       r0 += uint32_t(kGroups * R::U)) {
    uint32_t begin[R::U], end[R::U];
    uint4 old[R::U];
#pragma unroll
    for (int u = 0; u < R::U; ++u) {
      const uint32_t r = r0 + u;
      begin[u] = end[u] = 0u;
      if (r < rows) {
        begin[u] = r > 0u ? hist[r - 1] : 0u;
        end[u] = hist[r];
      }
      if (begin[u] != end[u])                 // untouched: not read
        old[u] = *reinterpret_cast<const uint4*>(
            own + r * uint32_t(4 * S) + 4 * gl);
    }
#pragma unroll
    for (int u = 0; u < R::U; ++u) {
      if (begin[u] == end[u]) continue;
      // the row's counts: sums of up to 15 keys in the nibbles, folded
      // in with a per-nibble saturating add
      uint32_t sum[4] = {0u, 0u, 0u, 0u}, cnt[4] = {0u, 0u, 0u, 0u};
      int pending = 0;
      for (uint32_t p = begin[u]; p < end[u]; ++p) {
        uint32_t inc[4];
        word_incs<S>(spat[p], gl, salt, k, inc);
#pragma unroll
        for (int c = 0; c < 4; ++c) sum[c] += inc[c];
        if (++pending == 15 || p + 1u == end[u]) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            cnt[c] = sat_add_nibbles(cnt[c], sum[c]);
            sum[c] = 0u;
          }
          pending = 0;
        }
      }
      *reinterpret_cast<uint4*>(own + (r0 + u) * uint32_t(4 * S) + 4 * gl) =
          make_uint4(apply_counts<OP>(old[u].x, cnt[0]),
                     apply_counts<OP>(old[u].y, cnt[1]),
                     apply_counts<OP>(old[u].z, cnt[2]),
                     apply_counts<OP>(old[u].w, cnt[3]));
    }
  }
}

// A chunk's (row, pattern) pairs, kNoRow for none, counting-sorted by row
// into spat; hist (rows words) ends as update_sorted_rows reads it. Ends on
// a barrier.
template <int PER>
__device__ __forceinline__ void sort_chunk(const uint32_t (&row)[PER],
                                           const uint32_t (&pat)[PER],
                                           uint32_t* hist, uint32_t* spat,
                                           uint32_t rows, uint32_t* sums) {
  for (uint32_t r = threadIdx.x; r < rows; r += blockDim.x) hist[r] = 0u;
  __syncthreads();
#pragma unroll
  for (int t = 0; t < PER; ++t)
    if (row[t] != kNoRow) atomicAdd(&hist[row[t]], 1u);
  __syncthreads();
  block_exclusive_scan(hist, int(rows), sums);
#pragma unroll
  for (int t = 0; t < PER; ++t)
    if (row[t] != kNoRow) spat[atomicAdd(&hist[row[t]], 1u)] = pat[t];
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The binned update
// ---------------------------------------------------------------------------

constexpr int kMaxBinRowBits = 13;                 // the apply's histogram
constexpr int kMaxGroupBins = 4096;                // 40 B a bin a pass
constexpr int kRoundKeys = 4;                      // keys a thread a round
constexpr uint32_t kSectorSlots = 4;               // u64 slots a sector
constexpr uint64_t kFillSlot = ~0ull;              // pads a run
constexpr int kApplyPer = 16;                      // slots an apply thread
constexpr int kApplyChunk = kGroupThreads * kApplyPer;
// A bin of more than kSplitSlots slots is cut into parts of kPartSlots
// where its rows' counts fit shared memory (counting_bin_split_kernel)
constexpr uint32_t kSplitSlots = 4u * kApplyChunk;
constexpr uint32_t kPartSlots = 2u * kApplyChunk;
constexpr long long kMaxBatch = 1LL << 30;

// Key i's pattern hash and global row (a bank's member * n_blocks +
// block), or false for an invalid slot.
__device__ __forceinline__ bool key_row(const uint2* keys,
                                        const int32_t* member,
                                        const uint8_t* valid, int64_t i,
                                        uint32_t block_mask, uint32_t& pat,
                                        uint32_t& grow) {
  if (valid != nullptr && valid[i] == 0) return false;
  uint32_t h_blk;
  hash_key(keys[i], pat, h_blk);
  grow = h_blk & block_mask;
  if (member != nullptr) grow += uint32_t(member[i]) * (block_mask + 1u);
  return true;
}

// bin_column_kernel and bin_scan_kernel for at most kBinThreads bins, by
// one CTA, a thread a bin: thread j walks bin j's column (counts[c][j]
// becomes chunk c's offset in the bin, each run padded to a whole sector of
// `sector` slots), then the CTA scans the bins' padded lengths into
// starts[j] and ends[j]. The same u32 sums as the two kernels: the same
// offsets, starts and ends. The counts are read through L2 (__ldcg): other
// CTAs of the count kernel wrote them.
__device__ __forceinline__ void column_scan(uint32_t* __restrict__ counts,
                                            uint32_t* __restrict__ starts,
                                            uint32_t* __restrict__ ends,
                                            int n_bins, int chunks,
                                            uint32_t sector) {
  __shared__ uint32_t warp_sums[kBinThreads / 32];
  const int j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5;
  uint32_t total = 0u;
  if (j < n_bins) {
#pragma unroll 8
    for (int c = 0; c < chunks; ++c) {
      uint32_t* cell = counts + size_t(c) * n_bins + j;
      const uint32_t v = __ldcg(cell);
      *cell = total;
      total += (v + sector - 1u) & ~(sector - 1u);
    }
  }
  uint32_t incl = total;                     // inclusive scan over the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {                           // scan the 32 warp sums
    uint32_t w = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  const uint32_t start =
      incl - total + (warp > 0 ? warp_sums[warp - 1] : 0u);
  if (j < n_bins) {
    starts[j] = start;
    ends[j] = start + total;
  }
}

// counts[c][j]: chunk c's valid keys in bin j. With `done` (at most
// kBinThreads bins), the CTA that finishes last also turns the counts into
// each bin's runs and slice (column_scan), so the column and scan kernels
// are not launched, and with `part_first` it does counting_bin_parts_kernel's
// work too; `done` is the stream's arrival counter, 0 between calls: the
// last CTA sets it back to 0.
__global__ void __launch_bounds__(kBinThreads)
    counting_bin_count_kernel(const uint2* __restrict__ keys,
                              const int32_t* __restrict__ member,
                              const uint8_t* __restrict__ valid,
                              uint32_t* __restrict__ counts, int64_t n,
                              uint32_t block_mask, int bin_row_bits,
                              int n_bins, uint32_t* __restrict__ done,
                              uint32_t* __restrict__ starts,
                              uint32_t* __restrict__ ends, uint32_t sector,
                              uint32_t* __restrict__ part_first) {
  extern __shared__ uint32_t hist[];
  __shared__ uint32_t arrived;
  __shared__ uint32_t sums[32];
  for (int j = threadIdx.x; j < n_bins; j += blockDim.x) hist[j] = 0u;
  __syncthreads();
  int64_t first, last;
  chunk_of(n, blockIdx.x, gridDim.x, first, last);
  for (int64_t i = first + threadIdx.x; i < last; i += blockDim.x) {
    uint32_t pat, grow;
    if (key_row(keys, member, valid, i, block_mask, pat, grow))
      atomicAdd(&hist[grow >> bin_row_bits], 1u);
  }
  __syncthreads();
  uint32_t* row = counts + size_t(blockIdx.x) * n_bins;
  for (int j = threadIdx.x; j < n_bins; j += blockDim.x) row[j] = hist[j];
  if (done == nullptr) return;
  __threadfence();                           // this CTA's row, to L2 first
  __syncthreads();
  if (threadIdx.x == 0) arrived = atomicAdd(done, 1u);
  __syncthreads();
  if (arrived != gridDim.x - 1u) return;
  __threadfence();
  column_scan(counts, starts, ends, n_bins, int(gridDim.x), sector);
  if (threadIdx.x == 0) *done = 0u;
  if (part_first == nullptr) return;
  __syncthreads();                           // starts and ends, written
  for (int j = threadIdx.x; j <= n_bins; j += blockDim.x) {
    const uint32_t len = j < n_bins ? ends[j] - starts[j] : 0u;
    part_first[j] = len > kSplitSlots ? (len + kPartSlots - 1u) / kPartSlots
                                      : 0u;
  }
  __syncthreads();
  block_exclusive_scan(part_first, n_bins + 1, sums);
}

// One CTA a chunk writes its valid keys' slots, (row in bin << 32) |
// pattern, into its runs, bins taken `group_bins` at a time (a pass over
// the chunk each). Slot s of a bin is written once: the bin's counter in
// shared memory hands out s. The sector the counter is in (`open`) is
// staged in shared memory and written out whole, as two 16-byte stores, by
// the thread that fills it. A round is kRoundKeys keys a thread:
//   A: take a slot; stage it in the open sector, keep it (the next sector),
//      or, further on, write it to the workspace (a sector filled within
//      one round is written in one burst, which L2 merges);
//   B: the thread that took a sector's last slot writes the sector; the
//      next sector opens, or the first untouched one if the round went past
//      it;
//   C: the kept slots go to the open sector, else to the workspace.
// At the end the last open sector is padded with kFillSlot to the run's
// end (cbf_bin_scatter_kernel's schedule, one slot a key).
__global__ void __launch_bounds__(kBinThreads, 1)
    counting_bin_scatter_kernel(const uint2* __restrict__ keys,
                                const int32_t* __restrict__ member,
                                const uint8_t* __restrict__ valid,
                                const uint32_t* __restrict__ offsets,
                                const uint32_t* __restrict__ starts,
                                uint64_t* __restrict__ slots, int64_t n,
                                uint32_t block_mask, int bin_row_bits,
                                int n_bins, int group_bins) {
  constexpr uint32_t kLast = kSectorSlots - 1u;
  extern __shared__ uint4 sector4[];
  uint64_t* sector = reinterpret_cast<uint64_t*>(sector4);
  uint32_t* taken = reinterpret_cast<uint32_t*>(sector + kSectorSlots *
                                                group_bins);
  uint32_t* open = taken + group_bins;
  int64_t first, last;
  chunk_of(n, blockIdx.x, gridDim.x, first, last);
  const int64_t per_round = int64_t(blockDim.x) * kRoundKeys;
  const int rounds = int((last - first + per_round - 1) / per_round);
  const uint32_t* row = offsets + size_t(blockIdx.x) * n_bins;
  const uint32_t row_mask = (1u << bin_row_bits) - 1u;
  for (int g0 = 0; g0 < n_bins; g0 += group_bins) {
    for (int j = threadIdx.x; j < group_bins; j += blockDim.x) {
      const uint32_t base = starts[g0 + j] + row[g0 + j];
      taken[j] = base;
      open[j] = base >> 2;
    }
    __syncthreads();
    for (int r = 0; r < rounds; ++r) {
      uint32_t lb[kRoundKeys], s[kRoundKeys];
      uint64_t v[kRoundKeys];
      int state[kRoundKeys];                   // 0 done, 1 staged, 2 kept
#pragma unroll
      for (int u = 0; u < kRoundKeys; ++u) {             // A
        state[u] = 0;
        lb[u] = s[u] = 0u;
        v[u] = 0u;
        const int64_t i =
            first + (int64_t(r) * kRoundKeys + u) * blockDim.x + threadIdx.x;
        uint32_t pat, grow;
        if (i >= last || !key_row(keys, member, valid, i, block_mask, pat,
                                  grow))
          continue;
        lb[u] = (grow >> bin_row_bits) - uint32_t(g0);
        if (lb[u] >= uint32_t(group_bins)) continue;
        v[u] = (uint64_t(grow & row_mask) << 32) | pat;
        s[u] = atomicAdd(&taken[lb[u]], 1u);
        const uint32_t sec = s[u] >> 2, op = open[lb[u]];
        if (sec == op) {
          sector[kSectorSlots * lb[u] + (s[u] & kLast)] = v[u];
          state[u] = 1;
        } else if (sec == op + 1u) {
          state[u] = 2;
        } else {
          slots[s[u]] = v[u];
        }
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kRoundKeys; ++u) {             // B
        if (state[u] != 1 || (s[u] & kLast) != kLast) continue;
        uint4* dst = reinterpret_cast<uint4*>(slots + (s[u] & ~kLast));
        dst[0] = sector4[2 * lb[u]];
        dst[1] = sector4[2 * lb[u] + 1];
        const uint32_t t = taken[lb[u]], next = (s[u] >> 2) + 1u;
        open[lb[u]] = t >= kSectorSlots * (next + 1u) ? (t + kLast) >> 2
                                                      : next;
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kRoundKeys; ++u) {             // C
        if (state[u] != 2) continue;
        if ((s[u] >> 2) == open[lb[u]])
          sector[kSectorSlots * lb[u] + (s[u] & kLast)] = v[u];
        else
          slots[s[u]] = v[u];
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < group_bins; j += blockDim.x) {
      const uint32_t t = taken[j];
      if ((t & kLast) == 0u) continue;         // the run ends on a sector
      if ((t >> 2) == open[j]) {
        for (uint32_t q = t & kLast; q <= kLast; ++q)
          sector[kSectorSlots * j + q] = kFillSlot;
        uint4* dst = reinterpret_cast<uint4*>(slots + (t & ~kLast));
        dst[0] = sector4[2 * j];
        dst[1] = sector4[2 * j + 1];
      } else {
        for (uint32_t q = t; q < ((t + kLast) & ~kLast); ++q)
          slots[q] = kFillSlot;
      }
    }
    __syncthreads();
  }
}

// One CTA: part_first[j], bin j's first part (the exclusive scan of the
// bins' parts: none for a bin of at most kSplitSlots slots, which
// counting_bin_apply_kernel takes whole, else ceil(length / kPartSlots));
// part_first[n_bins], the parts of the batch.
__global__ void __launch_bounds__(kGroupThreads)
    counting_bin_parts_kernel(const uint32_t* __restrict__ starts,
                              const uint32_t* __restrict__ ends,
                              uint32_t* __restrict__ part_first, int n_bins) {
  __shared__ uint32_t sums[32];
  for (int j = threadIdx.x; j <= n_bins; j += blockDim.x) {
    const uint32_t len = j < n_bins ? ends[j] - starts[j] : 0u;
    part_first[j] = len > kSplitSlots ? (len + kPartSlots - 1u) / kPartSlots
                                      : 0u;
  }
  __syncthreads();
  block_exclusive_scan(part_first, n_bins + 1, sums);
}

// A bin's rows: its first global row, and its rows (2^bin_row_bits, fewer
// for the last bin).
struct BinRows {
  uint32_t first, rows;
};

__device__ __forceinline__ BinRows bin_rows(int bin, uint32_t total_rows,
                                            int bin_row_bits) {
  const uint32_t first = uint32_t(bin) << bin_row_bits;
  const uint32_t cap_rows = 1u << bin_row_bits;
  return {first, total_rows - first < cap_rows ? total_rows - first
                                               : cap_rows};
}

// Slots [c0, end) of a bin's slice, at most a chunk, as (row, pattern)
// pairs; kNoRow past the end and for padding.
__device__ __forceinline__ void load_chunk(const uint64_t* slots, uint32_t c0,
                                           uint32_t end,
                                           uint32_t (&row)[kApplyPer],
                                           uint32_t (&pat)[kApplyPer]) {
#pragma unroll
  for (int t = 0; t < kApplyPer; ++t) {
    const uint32_t p = c0 + uint32_t(t * kGroupThreads) + threadIdx.x;
    const uint64_t v = p < end ? slots[p] : kFillSlot;
    row[t] = v == kFillSlot ? kNoRow : uint32_t(v >> 32);
    pat[t] = uint32_t(v);
  }
}

// One CTA a bin of at most split_slots slots (kSplitSlots where the split
// kernel takes the larger bins, else every bin): its slice [starts[b],
// ends[b]) in chunks of kApplyChunk slots, each counting-sorted by row and
// applied with update_sorted_rows, plain stores (no other CTA touches the
// bin's rows). An empty bin is left alone.
template <int S, int OP>
__global__ void __launch_bounds__(kGroupThreads, 1)
    counting_bin_apply_kernel(uint32_t* __restrict__ counters,
                              const uint64_t* __restrict__ slots,
                              const uint32_t* __restrict__ starts,
                              const uint32_t* __restrict__ ends,
                              const uint32_t* __restrict__ salts,
                              uint32_t total_rows, int bin_row_bits, int k,
                              uint32_t split_slots) {
  const uint32_t begin = starts[blockIdx.x], end = ends[blockIdx.x];
  if (begin == end || end - begin > split_slots) return;
  __shared__ uint32_t salt[kMaxSalts];
  __shared__ uint32_t sums[32];
  extern __shared__ uint32_t dyn[];
  const BinRows br = bin_rows(blockIdx.x, total_rows, bin_row_bits);
  uint32_t* own = counters + uint64_t(br.first) * uint32_t(4 * S);
  uint32_t* hist = dyn;                     // rows: counts, then run ends
  uint32_t* spat = dyn + (1u << bin_row_bits);   // the chunk's h_pat
  for (int i = threadIdx.x; i < kMaxSalts; i += blockDim.x) salt[i] = salts[i];
  __syncthreads();
  for (uint32_t c0 = begin; c0 < end; c0 += kApplyChunk) {
    uint32_t row[kApplyPer], pat[kApplyPer];
    load_chunk(slots, c0, end, row, pat);
    sort_chunk<kApplyPer>(row, pat, hist, spat, br.rows, sums);
    update_sorted_rows<S, OP>(own, hist, spat, br.rows, salt, k);
    __syncthreads();                          // hist and spat are reused
  }
}

// The parts of the bins past kSplitSlots slots (skewed keys: a bank's hot
// member), a CTA a part in turn (grid-stride: the grid is at most the
// card's CTAs, which end at once where no bin is split). Part p of bin j is
// slots [starts[j] + p * kPartSlots, ...) of its slice. A part sums its
// chunks' counts per row in shared memory (update_sorted_rows's add form
// on zeroed words: saturating per-nibble counts), then applies each touched
// counter word's closed form once by CAS: the parts of a bin run at once.
template <int S, int OP>
__global__ void __launch_bounds__(kGroupThreads, 1)
    counting_bin_split_kernel(uint32_t* __restrict__ counters,
                              const uint64_t* __restrict__ slots,
                              const uint32_t* __restrict__ starts,
                              const uint32_t* __restrict__ ends,
                              const uint32_t* __restrict__ part_first,
                              const uint32_t* __restrict__ salts,
                              uint32_t total_rows, int n_bins,
                              int bin_row_bits, int k) {
  const uint32_t parts = part_first[n_bins];
  if (blockIdx.x >= parts) return;
  __shared__ uint32_t salt[kMaxSalts];
  __shared__ uint32_t sums[32];
  extern __shared__ uint4 acc4[];
  const uint32_t cap_rows = 1u << bin_row_bits;
  uint32_t* acc = reinterpret_cast<uint32_t*>(acc4);   // cap_rows x 4S
  uint32_t* hist = acc + cap_rows * uint32_t(4 * S);
  uint32_t* spat = hist + cap_rows;
  for (int i = threadIdx.x; i < kMaxSalts; i += blockDim.x) salt[i] = salts[i];
  for (uint32_t part = blockIdx.x; part < parts; part += gridDim.x) {
    int bin = 0;                            // the last bin starting <= part
    for (int step = kMaxBins / 2; step > 0; step >>= 1)
      if (bin + step < n_bins && part_first[bin + step] <= part) bin += step;
    const uint32_t begin =
        starts[bin] + (part - part_first[bin]) * kPartSlots;
    const uint32_t end =
        ends[bin] - begin < kPartSlots ? ends[bin] : begin + kPartSlots;
    const BinRows br = bin_rows(bin, total_rows, bin_row_bits);
    uint32_t* own = counters + uint64_t(br.first) * uint32_t(4 * S);
    const uint32_t words = br.rows * uint32_t(4 * S);
    for (uint32_t w = threadIdx.x; w < words; w += blockDim.x) acc[w] = 0u;
    __syncthreads();
    for (uint32_t c0 = begin; c0 < end; c0 += kApplyChunk) {
      uint32_t row[kApplyPer], pat[kApplyPer];
      load_chunk(slots, c0, end, row, pat);
      sort_chunk<kApplyPer>(row, pat, hist, spat, br.rows, sums);
      update_sorted_rows<S, kAdd>(acc, hist, spat, br.rows, salt, k);
      __syncthreads();                        // hist and spat are reused
    }
    for (uint32_t w = threadIdx.x; w < words; w += blockDim.x)
      if (acc[w] != 0u) cas_counts<OP>(own + w, __ldcg(own + w), acc[w]);
    __syncthreads();                          // acc is reused
  }
}

// ---------------------------------------------------------------------------
// The grouped and global partitioned kernels
// ---------------------------------------------------------------------------

// One CTA a segment of `rows` counter rows (4S words each): chunks of
// kGroupChunk slots, each counting-sorted by row in shared memory, then a
// group of S lanes a touched row (comment at the top).
template <int S, int OP>
__global__ void __launch_bounds__(kGroupThreads, 2)
    counting_partitioned_grouped_kernel(const uint2* __restrict__ keys,
                                        const uint8_t* __restrict__ valid,
                                        uint32_t* __restrict__ counters,
                                        const uint32_t* __restrict__ salts,
                                        int64_t capacity, uint32_t seg_cwords,
                                        uint32_t block_mask, int k,
                                        uint32_t rows) {
  __shared__ uint32_t salt[3 * kMaxSalts];
  __shared__ uint32_t sums[32];
  extern __shared__ uint32_t dyn[];
  uint32_t* hist = dyn;               // rows: counts, then run ends
  uint32_t* spat = dyn + rows;        // the chunk's h_pat, sorted by row
  stage_salts(salt, salts);
  const uint2* seg_keys = keys + uint64_t(blockIdx.x) * capacity;
  const uint8_t* seg_valid = valid + uint64_t(blockIdx.x) * capacity;
  uint32_t* own = counters + uint64_t(blockIdx.x) * seg_cwords;
  for (int64_t c0 = 0; c0 < capacity; c0 += kGroupChunk) {
    uint32_t row[kGroupPer], pat[kGroupPer];
    bool any = false;
    uint8_t live[kGroupPer];
#pragma unroll
    for (int t = 0; t < kGroupPer; ++t) {     // the valid bytes in flight
      const int64_t i = c0 + t * kGroupThreads + threadIdx.x;
      live[t] = i < capacity ? seg_valid[i] : uint8_t(0);
    }
#pragma unroll
    for (int t = 0; t < kGroupPer; ++t) {
      const int64_t i = c0 + t * kGroupThreads + threadIdx.x;
      row[t] = kNoRow;
      pat[t] = 0u;
      if (live[t] != 0) {
        uint32_t h_blk;
        hash_key(seg_keys[i], pat[t], h_blk);
        row[t] = (h_blk & block_mask) % rows;
        any = true;
      }
    }
    if (!__syncthreads_or(any)) continue;       // a chunk of padding
    sort_chunk<kGroupPer>(row, pat, hist, spat, rows, sums);
    update_sorted_rows<S, OP>(own, hist, spat, rows, salt, k);
    __syncthreads();                            // hist and spat are reused
  }
}

// 32 slots a warp, min(4S, 32) lanes a key and a lane a counter word, one
// CAS loop a lane whose mask byte is nonzero (comment at the top).
template <int S, int OP>
__global__ void __launch_bounds__(kPartThreads)
    counting_partitioned_global_kernel(const uint2* __restrict__ keys,
                                       const uint8_t* __restrict__ valid,
                                       uint32_t* __restrict__ counters,
                                       const uint32_t* __restrict__ salts,
                                       int64_t n_slots, int64_t capacity,
                                       uint32_t seg_cwords,
                                       uint32_t block_mask, int k) {
  using R = RowLanes<S>;
  __shared__ uint32_t salt[3 * kMaxSalts];
  stage_salts(salt, salts);
  const int lane = threadIdx.x & 31, gl = lane % R::L, grp = lane / R::L;
  const int64_t i = int64_t(blockIdx.x) * kPartThreads + threadIdx.x;
  const bool live = i < n_slots && valid[i] != 0;
  uint32_t h_pat = 0u;
  uint64_t start = 0u;
  if (live) {
    uint32_t h_blk;
    hash_key(keys[i], h_pat, h_blk);
    start = uint64_t(i / capacity) * seg_cwords +
            ((h_blk & block_mask) * uint32_t(4 * S)) % seg_cwords;
  }
  const uint32_t live_mask = __ballot_sync(0xffffffffu, live);
  if (live_mask == 0u) return;                  // the whole warp
  for (int t0 = 0; t0 < 32; t0 += R::G) {
    const int src = t0 + grp;
    const uint32_t h = __shfl_sync(0xffffffffu, h_pat, src);
    const uint64_t row = __shfl_sync(0xffffffffu, start, src);
    if (((live_mask >> src) & 1u) == 0u) continue;
#pragma unroll
    for (int t = 0; t < R::W; ++t) {
      const int word = gl + R::L * t;
      const uint32_t inc = nibble_inc<S>(h, word, salt, k);
      if (inc != 0u) cas_word<OP>(counters + row + word, inc);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    counting_decay_kernel(uint32_t* counters, int64_t n_words) {
  const int64_t n4 = n_words / 4;
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  const int64_t first = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  uint4* vec = reinterpret_cast<uint4*>(counters);
  for (int64_t i = first; i < n4; i += stride) {
    uint4 w = vec[i];
    w.x -= nib_nonzero(w.x);
    w.y -= nib_nonzero(w.y);
    w.z -= nib_nonzero(w.z);
    w.w -= nib_nonzero(w.w);
    vec[i] = w;
  }
  for (int64_t i = 4 * n4 + first; i < n_words; i += stride)
    counters[i] -= nib_nonzero(counters[i]);
}

// ---------------------------------------------------------------------------
// Host-side dispatch
// ---------------------------------------------------------------------------

struct UpdateArgs {
  const uint2* keys;
  const int32_t* member;
  const uint8_t* valid;
  uint32_t* counters;
  const uint32_t* salts;
  int64_t n;
  uint64_t member_words;
  uint32_t block_mask;
  int k;
};

template <int S, int OP, bool BANK>
int launch_update(const UpdateArgs& a, cudaStream_t stream) {
  const unsigned grid = unsigned((a.n + kThreads - 1) / kThreads);
  counting_update_kernel<S, OP, BANK><<<grid, kThreads, 0, stream>>>(
      a.keys, a.member, a.valid, a.counters, a.salts, a.n, a.member_words,
      a.block_mask, a.k);
  return int(cudaGetLastError());
}

template <int OP, bool BANK>
int update_op(int s, const UpdateArgs& a, cudaStream_t st) {
  switch (s) {
    case 1:
      return launch_update<1, OP, BANK>(a, st);
    case 2:
      return launch_update<2, OP, BANK>(a, st);
    case 4:
      return launch_update<4, OP, BANK>(a, st);
    case 8:
      return launch_update<8, OP, BANK>(a, st);
    case 16:
      return launch_update<16, OP, BANK>(a, st);
    case 32:
      return launch_update<32, OP, BANK>(a, st);
  }
  return -1;
}

struct BinGeometry {
  int n_bins, group_bins;
  size_t count_smem, scatter_smem, apply_smem, split_smem;
  bool split;                     // over-full bins go to the split kernel
  int split_ctas;                 // set by prepare_binned
};

constexpr size_t kSaltsSmem = (kMaxSalts + 32) * sizeof(uint32_t);

// The binned kernels' geometry for total_rows rows of 4s words in bins of
// 2^bin_row_bits rows on a card with `optin` bytes of shared memory a CTA,
// or false where they have none. Over-full bins are split where a bin's
// rows' counts fit shared memory beside a chunk.
bool bin_geometry(int s, uint32_t total_rows, int bin_row_bits, int optin,
                  BinGeometry& g) {
  if (total_rows == 0u || bin_row_bits < 0 ||
      bin_row_bits > kMaxBinRowBits)
    return false;
  const uint64_t bins =
      (uint64_t(total_rows) + (1ull << bin_row_bits) - 1) >> bin_row_bits;
  if (bins > uint64_t(kMaxBins)) return false;
  const size_t rows = size_t(1) << bin_row_bits;
  g.n_bins = int(bins);
  g.group_bins = g.n_bins < kMaxGroupBins ? g.n_bins : kMaxGroupBins;
  g.count_smem = size_t(g.n_bins) * sizeof(uint32_t);
  g.scatter_smem = size_t(g.group_bins) *
                   (kSectorSlots * sizeof(uint64_t) + 2 * sizeof(uint32_t));
  g.apply_smem = (rows + kApplyChunk) * sizeof(uint32_t);
  const size_t acc = rows * 16 * size_t(s);
  g.split = g.apply_smem + acc + kSaltsSmem <= size_t(optin);
  g.split_smem = g.apply_smem + acc;
  g.split_ctas = 0;
  return true;
}

template <int OP>
const void* apply_for(int s, bool split) {
#define COUNTING_APPLY(S)                                                    \
  return split ? reinterpret_cast<const void*>(                              \
                     counting_bin_split_kernel<S, OP>)                        \
               : reinterpret_cast<const void*>(counting_bin_apply_kernel<S, OP>)
  switch (s) {
    case 1:
      COUNTING_APPLY(1);
    case 2:
      COUNTING_APPLY(2);
    case 4:
      COUNTING_APPLY(4);
    case 8:
      COUNTING_APPLY(8);
    case 16:
      COUNTING_APPLY(16);
    case 32:
      COUNTING_APPLY(32);
  }
#undef COUNTING_APPLY
  return nullptr;
}

const void* apply_of(int s, int op, bool split) {
  if (op == kAdd) return apply_for<kAdd>(s, split);
  if (op == kRemove) return apply_for<kRemove>(s, split);
  return nullptr;
}

// The card's opt-in shared memory a CTA, and its SMs, on the current
// device (in *dev); asked once a device.
int card_limits(int* dev, int* optin, int* sms) {
  constexpr int kDevices = 64;
  static int known_optin[kDevices], known_sms[kDevices];
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return int(err);
  if (*dev < kDevices && known_sms[*dev] > 0) {
    *optin = known_optin[*dev];
    *sms = known_sms[*dev];
    return 0;
  }
  err = cudaDeviceGetAttribute(optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev);
  if (err == cudaSuccess && *dev < kDevices) {
    known_optin[*dev] = *optin;
    known_sms[*dev] = *sms;
  }
  return int(err);
}

// prepare_binned's results by device, kernels and shared memory: raising
// the limits and asking for the occupancy cost more host time than a small
// batch's launches, so each geometry does them once on a device.
using PreparedKey = std::tuple<int, const void*, const void*, size_t, size_t,
                               size_t, bool, size_t>;
std::mutex prepared_lock;
std::map<PreparedKey, std::pair<int, int>> prepared;

// Raise a kernel's dynamic shared memory limit to all that the card allows
// beside its static shared memory. Every geometry sets the same limit, so
// none lowers the limit that another's kept answer relies on.
cudaError_t raise_smem_limit(const void* kernel, int optin) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - int(attr.sharedSizeBytes));
  return err;
}

// Raise the binned kernels' shared memory limits; the scatter's CTAs that
// fill the card (the chunks of a batch) in *chunks, the split kernel's in
// g->split_ctas. -1 for a geometry the card's shared memory cannot take.
int prepare_binned(BinGeometry* g, const void* apply, const void* split,
                   int dev, int optin, int sms, int* chunks) {
  if (apply == nullptr || split == nullptr ||
      g->scatter_smem > size_t(optin) || g->count_smem > size_t(optin) ||
      g->apply_smem + kSaltsSmem > size_t(optin))
    return -1;
  const PreparedKey key{dev,           apply,           split,
                        g->count_smem, g->scatter_smem, g->apply_smem,
                        g->split,      g->split_smem};
  std::lock_guard<std::mutex> hold(prepared_lock);
  const auto found = prepared.find(key);
  if (found != prepared.end()) {
    *chunks = found->second.first;
    g->split_ctas = found->second.second;
    return 0;
  }
  const void* count = reinterpret_cast<const void*>(counting_bin_count_kernel);
  const void* scatter =
      reinterpret_cast<const void*>(counting_bin_scatter_kernel);
  int per_sm = 0, split_per_sm = 0;
  cudaError_t err = raise_smem_limit(count, optin);
  if (err == cudaSuccess) err = raise_smem_limit(scatter, optin);
  if (err == cudaSuccess) err = raise_smem_limit(apply, optin);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, scatter, kBinThreads, g->scatter_smem);
  if (err == cudaSuccess && g->split) err = raise_smem_limit(split, optin);
  if (err == cudaSuccess && g->split)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &split_per_sm, split, kGroupThreads, g->split_smem);
  if (err != cudaSuccess) return int(err);
  sms = sms > 0 ? sms : 1;
  *chunks = sms * (per_sm > 0 ? per_sm : 1);
  g->split_ctas = sms * (split_per_sm > 0 ? split_per_sm : 1);
  prepared.emplace(key, std::make_pair(*chunks, g->split_ctas));
  return 0;
}

struct PartitionedArgs {
  const uint2* keys;
  const uint8_t* valid;
  uint32_t* counters;
  const uint32_t* salts;
  int64_t n_segments, capacity;
  uint32_t seg_cwords, block_mask;
  int k, op, path;
};

enum PartitionedPath : int { kGlobal = 0, kGrouped = 1 };

// Dynamic shared memory of the grouped kernel for segments of `rows` rows.
size_t grouped_smem_bytes(uint32_t rows) {
  return (size_t(rows) + kGroupChunk) * sizeof(uint32_t);
}

template <int S, int OP>
int launch_partitioned(const PartitionedArgs& a, cudaStream_t stream) {
  if (a.path == kGrouped) {
    const uint32_t rows = a.seg_cwords / uint32_t(4 * S);
    if (a.seg_cwords % uint32_t(4 * S) || rows == 0u ||
        rows > uint32_t(kMaxGroupRows))
      return -1;
    const size_t bytes = grouped_smem_bytes(rows);
    const cudaError_t err = cudaFuncSetAttribute(
        counting_partitioned_grouped_kernel<S, OP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return int(err);
    counting_partitioned_grouped_kernel<S, OP>
        <<<unsigned(a.n_segments), kGroupThreads, bytes, stream>>>(
            a.keys, a.valid, a.counters, a.salts, a.capacity, a.seg_cwords,
            a.block_mask, a.k, rows);
  } else if (a.path == kGlobal) {
    const int64_t n_slots = a.n_segments * a.capacity;
    const unsigned grid =
        unsigned((n_slots + kPartThreads - 1) / kPartThreads);
    counting_partitioned_global_kernel<S, OP>
        <<<grid, kPartThreads, 0, stream>>>(a.keys, a.valid, a.counters,
                                           a.salts, n_slots, a.capacity,
                                           a.seg_cwords, a.block_mask, a.k);
  } else {
    return -1;
  }
  return int(cudaGetLastError());
}

template <int OP>
int partitioned_op(int s, const PartitionedArgs& a, cudaStream_t st) {
  switch (s) {
    case 1:
      return launch_partitioned<1, OP>(a, st);
    case 2:
      return launch_partitioned<2, OP>(a, st);
    case 4:
      return launch_partitioned<4, OP>(a, st);
    case 8:
      return launch_partitioned<8, OP>(a, st);
    case 16:
      return launch_partitioned<16, OP>(a, st);
    case 32:
      return launch_partitioned<32, OP>(a, st);
  }
  return -1;
}

}  // namespace

extern "C" {

// The one-pass update. keys: (n, 2) int32 [hi, lo], 8-byte aligned;
// member: (n,) int32 in [0, B), or null for one filter (member_words then
// unread); valid: (n,) uint8 or null (every key valid); counters: one
// filter's (storage_words,) or the (B, member_words) bank, int32, 16-byte
// aligned; salts: (3, 96) int32; op: 0 add, 1 remove.
int counting_update(const void* keys, const void* member, const void* valid,
                    void* counters, const void* salts, long long n,
                    unsigned long long member_words, unsigned block_mask,
                    int s, int k, int op, void* stream) {
  if (n == 0) return 0;
  const UpdateArgs a{static_cast<const uint2*>(keys),
                     static_cast<const int32_t*>(member),
                     static_cast<const uint8_t*>(valid),
                     static_cast<uint32_t*>(counters),
                     static_cast<const uint32_t*>(salts), n, member_words,
                     block_mask, k};
  const auto st = static_cast<cudaStream_t>(stream);
  const bool bank = member != nullptr;
  if (op == kAdd)
    return bank ? update_op<kAdd, true>(s, a, st)
                : update_op<kAdd, false>(s, a, st);
  if (op == kRemove)
    return bank ? update_op<kRemove, true>(s, a, st)
                : update_op<kRemove, false>(s, a, st);
  return -1;
}

// Chunks (scatter CTAs) of a binned update on the current device, which
// size its workspace; -1 for a geometry without kernels, or an error.
int counting_binned_chunks(int s, unsigned total_rows, int bin_row_bits) {
  BinGeometry g;
  int dev = 0, optin = 0, sms = 0, chunks = 0;
  if (card_limits(&dev, &optin, &sms) != 0 ||
      !bin_geometry(s, total_rows, bin_row_bits, optin, g) ||
      prepare_binned(&g, apply_of(s, kAdd, false), apply_of(s, kAdd, true),
                     dev, optin, sms, &chunks) != 0)
    return -1;
  return chunks;
}

// A stream's arrival counter for the count kernel's last-CTA scan, made
// and zeroed once a device and stream; each scan sets it back to 0, and a
// stream runs one count kernel at a time.
std::mutex arrival_lock;
std::map<std::pair<int, cudaStream_t>, uint32_t*> arrival_counters;

cudaError_t arrival_counter(int dev, cudaStream_t st, uint32_t** out) {
  std::lock_guard<std::mutex> hold(arrival_lock);
  const auto key = std::make_pair(dev, st);
  const auto found = arrival_counters.find(key);
  if (found != arrival_counters.end()) {
    *out = found->second;
    return cudaSuccess;
  }
  uint32_t* counter = nullptr;
  cudaError_t err = cudaMalloc(&counter, sizeof(uint32_t));
  if (err == cudaSuccess)
    err = cudaMemsetAsync(counter, 0, sizeof(uint32_t), st);
  if (err != cudaSuccess) {
    if (counter != nullptr) cudaFree(counter);
    return err;
  }
  arrival_counters.emplace(key, counter);
  *out = counter;
  return cudaSuccess;
}

// The binned update (three to seven kernels an internal batch). member, valid: as
// counting_update; total_rows: the counter rows (B * n_blocks for a
// bank), below 2^32; work: u32 workspace, 8-word aligned: counts (chunks x
// n_bins), starts, ends (n_bins each), the bins' first parts (n_bins + 1),
// padded to 8 words, then the u64 slots (min(n, batch) + 3 * chunks *
// n_bins); batch: keys an internal batch (<= 2^30); chunks:
// counting_binned_chunks(). Updates counters in place.
int counting_update_binned(const void* keys, const void* member,
                           const void* valid, void* counters,
                           const void* salts, void* work, long long n,
                           unsigned total_rows, unsigned block_mask, int s,
                           int k, int op, int bin_row_bits, long long batch,
                           int chunks, void* stream) {
  BinGeometry g;
  int dev = 0, optin = 0, sms = 0;
  const int bad_card = card_limits(&dev, &optin, &sms);
  if (bad_card) return bad_card;
  if (!bin_geometry(s, total_rows, bin_row_bits, optin, g) || batch < 1 ||
      batch > kMaxBatch || chunks < 1 || (op != kAdd && op != kRemove))
    return -1;
  if (n == 0) return 0;
  const void* apply = apply_of(s, op, false);
  const void* split = apply_of(s, op, true);
  int card_chunks = 0;
  const int bad = prepare_binned(&g, apply, split, dev, optin, sms,
                                     &card_chunks);
  if (bad) return bad;
  const auto st = static_cast<cudaStream_t>(stream);
  uint32_t* counts = static_cast<uint32_t*>(work);
  uint32_t* starts = counts + size_t(chunks) * g.n_bins;
  uint32_t* ends = starts + g.n_bins;
  uint32_t* part_first = ends + g.n_bins;
  const size_t head = (size_t(chunks) + 3) * size_t(g.n_bins) + 1;
  uint64_t* slots =
      reinterpret_cast<uint64_t*>(counts + ((head + 7) & ~size_t(7)));
  const uint2* k2 = static_cast<const uint2*>(keys);
  const int32_t* mem = static_cast<const int32_t*>(member);
  const uint8_t* val = static_cast<const uint8_t*>(valid);
  uint32_t* c = static_cast<uint32_t*>(counters);
  const uint32_t* sl = static_cast<const uint32_t*>(salts);
  int n_bins = g.n_bins;
  uint32_t split_slots = g.split ? kSplitSlots : ~0u;
  const unsigned column_grid =
      unsigned((g.n_bins + kColumnThreads - 1) / kColumnThreads);
  uint32_t* done = nullptr;         // the count kernel scans (<= 1024 bins)
  if (g.n_bins <= kBinThreads) {
    const cudaError_t err = arrival_counter(dev, st, &done);
    if (err != cudaSuccess) return int(err);
  }
  for (long long first = 0; first < n; first += batch) {
    const long long nb = n - first < batch ? n - first : batch;
    const int32_t* m = mem != nullptr ? mem + first : nullptr;
    const uint8_t* v = val != nullptr ? val + first : nullptr;
    // a bin can pass kSplitSlots where the batch's slots do; its parts are
    // at most one a kPartSlots slots
    const long long slots_in = nb + 3LL * chunks * g.n_bins;
    const bool split_bins = g.split && slots_in > kSplitSlots;
    counting_bin_count_kernel<<<chunks, kBinThreads, g.count_smem, st>>>(
        k2 + first, m, v, counts, nb, block_mask, bin_row_bits, g.n_bins,
        done, starts, ends, kSectorSlots,
        done != nullptr && split_bins ? part_first : nullptr);
    if (done == nullptr) {
      bin_column_kernel<<<column_grid, kColumnThreads, 0, st>>>(
          counts, ends, g.n_bins, chunks, kSectorSlots);
      bin_scan_kernel<<<1, kBinThreads, 0, st>>>(starts, ends, g.n_bins);
    }
    counting_bin_scatter_kernel<<<chunks, kBinThreads, g.scatter_smem, st>>>(
        k2 + first, m, v, counts, starts, slots, nb, block_mask,
        bin_row_bits, g.n_bins, g.group_bins);
    void* apply_args[] = {&c,          &slots,      &starts,       &ends,
                          &sl,         &total_rows, &bin_row_bits, &k,
                          &split_slots};
    cudaError_t err =
        cudaLaunchKernel(apply, dim3(unsigned(g.n_bins)), dim3(kGroupThreads),
                         apply_args, g.apply_smem, st);
    if (err == cudaSuccess && split_bins) {
      if (done == nullptr)           // else the count kernel's last CTA did
        counting_bin_parts_kernel<<<1, kGroupThreads, 0, st>>>(
            starts, ends, part_first, g.n_bins);
      void* split_args[] = {&c,          &slots,  &starts,     &ends,
                            &part_first, &sl,     &total_rows, &n_bins,
                            &bin_row_bits, &k};
      const long long most_parts = slots_in / kPartSlots;
      const long long grid =
          most_parts < g.split_ctas ? most_parts : g.split_ctas;
      err = cudaLaunchKernel(split, dim3(unsigned(grid)),
                             dim3(kGroupThreads), split_args, g.split_smem,
                             st);
    }
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  return int(cudaGetLastError());
}

// Partitioned update. keys: (n_segments, capacity, 2) int32, 8-byte
// aligned; valid: (n_segments, capacity) uint8; counters:
// (n_segments * seg_cwords,) int32, 16-byte aligned; op: 0 add, 1 remove;
// path: 1 the grouped kernel (seg_cwords a multiple of 4s, at most 8192
// rows a segment, 4 (rows + 4096) bytes of shared memory a CTA), 0 the
// global CAS kernel.
int counting_update_partitioned(const void* keys, const void* valid,
                                void* counters, const void* salts,
                                long long n_segments, long long capacity,
                                unsigned seg_cwords, unsigned block_mask,
                                int s, int k, int op, int path,
                                void* stream) {
  if (n_segments <= 0 || capacity <= 0) return 0;
  const PartitionedArgs a{static_cast<const uint2*>(keys),
                          static_cast<const uint8_t*>(valid),
                          static_cast<uint32_t*>(counters),
                          static_cast<const uint32_t*>(salts), n_segments,
                          capacity, seg_cwords, block_mask, k, op, path};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (op == kAdd) return partitioned_op<kAdd>(s, a, st);
  if (op == kRemove) return partitioned_op<kRemove>(s, a, st);
  return -1;
}

// counters: (n_words,) int32, 16-byte aligned; updated in place.
int counting_decay(void* counters, long long n_words, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long n4 = (n_words + 3) / 4;
  long long grid = (n4 + kThreads - 1) / kThreads;
  const long long cap = 8LL * (sms > 0 ? sms : 1);
  if (grid > cap) grid = cap;
  if (grid < 1) grid = 1;
  counting_decay_kernel<<<unsigned(grid), kThreads, 0, st>>>(
      static_cast<uint32_t*>(counters), n_words);
  return int(cudaGetLastError());
}

}  // extern "C"
