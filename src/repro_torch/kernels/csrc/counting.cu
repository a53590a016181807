// Counting Bloom filter kernels for Hopper (sm_90a): bulk update of packed
// 4-bit counters (saturating increment, guarded decrement), membership on
// counter occupancy, and the decay pass, for the countingbf variant.
//
// Replaces eight Pallas entry points of repro/kernels/countingbf.py:
//   counting_update_kernel   <- update_vmem (_update_vmem_kernel,
//                               _update_vmem_gather_kernel,
//                               _update_vmem_coop_kernel) and update_hbm
//                               (_update_hbm_kernel)
//   counting_contains_kernel <- contains_vmem (_contains_vmem_kernel,
//                               _contains_vmem_gather_kernel,
//                               _contains_vmem_coop_kernel) and
//                               contains_hbm (_contains_hbm_kernel,
//                               _contains_hbm_coop_kernel)
//   counting_decay_kernel    <- decay (_decay_kernel)
//   counting_update_kernel<S, true>   <- bank_update_vmem
//                               (_bank_update_vmem_kernel,
//                               _bank_update_vmem_gather_kernel)
//   counting_contains_kernel<.., true> <- bank_contains_vmem
//                               (_bank_contains_vmem_gather_kernel)
//   counting_partitioned_grouped_kernel<S, OP> and
//   counting_partitioned_global_kernel<S, OP> <- update_partitioned
//                               (_update_partitioned_kernel)
//
// Layout. Logical bit i of the sbf-placed mask owns nibble i of the flat
// counter array: logical word j of a block is counter words 4j..4j+3 (one
// aligned 16-byte group), byte c of the mask word goes to counter word
// 4j+c, bit b of that byte to nibble b.
//
// Design. The TPU has no atomics, so its kernels sort each tile by counter
// row and own every read-modify-write. Hopper has 32-bit atomics but none
// of 4 bits, and atomicAdd would carry out of a nibble at 15 into its
// neighbour. So:
// * counting_update_kernel<S>: one thread per key. It hashes the key,
//   builds its sbf mask and, for every nonzero mask byte, runs an atomicCAS
//   loop on that counter word with sat_inc_word (add) or guard_dec_word
//   (remove) applied to all the byte's nibbles at once. Both updates are
//   order-free per nibble (add gives min(old + count, 15); remove gives
//   old == 15 ? 15 : max(old - count, 0)), so any interleaving of the CAS
//   loops gives the sequential reference's words bit for bit. A loop stops
//   as soon as the update would not change the word: within one launch the
//   counters only move one way, so a saturated (add) or 0/15 (remove)
//   nibble seen once stays so. Bound: L2 atomic throughput (k CAS per key
//   for one bit per logical word, as B = 256, k = 8 gives); in the DRAM
//   regime each touched sector is also fetched from DRAM. A sorted,
//   coalesced update (the TPU's schedule) is later perf work.
// * counting_contains_kernel<S, PHI, DEPTH>: a thread owns DEPTH keys
//   (strided by blockDim so key loads coalesce). It hashes them and builds
//   their masks, then walks the logical words: for each one it loads, for
//   every key still alive, the PHI-word chunks (at most 128 bits) whose
//   mask bytes are nonzero, and tests (nib_nonzero(w) & inc) == inc. A key
//   dies at its first failing word and loads nothing more; the walk ends
//   when all DEPTH keys are dead. The DEPTH keys' loads in flight take the
//   place of contains_hbm's DMA ring. Bound: DRAM bytes in the DRAM regime
//   (the touched 32-byte sectors of a 16 s-byte counter row, 128 B a key
//   for B = 256), L2 bandwidth in the L2 regime.
// * counting_decay_kernel: a grid-stride pass of w - nib_nonzero(w) with
//   128-bit loads and stores. Bound: DRAM bytes (every counter read and
//   written once).
//
// * Banks (BANK = true): a (B, 4 n_words) counter bank is one counter
//   array of B * n_blocks rows; key i's counter row starts at
//   member[i] * member_words + (h_blk & block_mask) * 4S (64-bit offsets,
//   member_words = 4 n_words), so B members take one launch in either
//   regime (the JAX package has only the VMEM bank kernels). The update is
//   valid-masked (write padding is the zero key on member 0, a real key)
//   and its atomicCAS loop is unchanged: order-free per nibble, so exact
//   under skewed member mixes too. The bank contains uses PHI = 4 and
//   DEPTH keys a thread, as contains_hbm does. The whole bank decays with
//   one counting_decay_kernel launch over its flat words.
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
//     nibble), applies the closed forms once, min(old + c, 15) for add and
//     old == 15 ? 15 : max(old - c, 0) for remove, with plain integer
//     operations on the even and odd nibbles as bytes, and stores the row
//     once. Chunks of
//     one segment run in order in one CTA, and two chunks' closed forms
//     compose to the closed form of their sum, so a row that spans chunks
//     is exact.
//     Shared memory is the key buffer and the row histogram, 4 (rows +
//     kGroupChunk) bytes (at most 48 KiB), not the segment: two CTAs fit
//     an SM. Bound: the keys and valid bytes read once, each touched row
//     read and written once a chunk. It replaces a design that staged the
//     whole segment in shared memory (128 KiB at the fitting count: one
//     CTA an SM, copy in, CAS loops and copy out in series) and ran one CAS
//     loop a nonzero mask byte and key on the staged words.
//   - counting_partitioned_global_kernel<S, OP> (path 0): where a
//     segment's rows do not fit the histogram (few, large segments: JAX's
//     default n_segments = 8) or too few segments fill the card. A warp
//     takes 32 slots; each lane hashes one, and the warp walks them with
//     min(4S, 32) lanes a key, a lane a counter word (32 / L keys at
//     once), sharing each key's hash by shuffle, as the blocked add does;
//     a lane whose mask byte is nonzero runs the sat_inc_word /
//     guard_dec_word CAS loop on its word. A key's loads and CAS loops are
//     one coalesced row request, not 4S dependent ones. Bound: L2 atomic
//     throughput on the touched words.
//
// C interface for ctypes: each entry point returns cudaGetLastError() after
// its launch (or -1 for a shape that has no instantiation). The wrappers
// check every member id against [0, B) before a bank launch.

#include "bloom_common.cuh"

namespace {

constexpr uint32_t kNibLsb = 0x11111111u;
constexpr int kMaxInFlight = 64;  // mask words a contains thread holds

enum Op : int { kAdd = 0, kRemove = 1 };

__device__ __forceinline__ uint32_t nib_nonzero(uint32_t w) {
  return (w | (w >> 1) | (w >> 2) | (w >> 3)) & kNibLsb;
}

__device__ __forceinline__ uint32_t nib_saturated(uint32_t w) {
  return w & (w >> 1) & (w >> 2) & (w >> 3) & kNibLsb;
}

__device__ __forceinline__ uint32_t sat_inc_word(uint32_t w, uint32_t inc) {
  return w + (inc & ~nib_saturated(w));
}

__device__ __forceinline__ uint32_t guard_dec_word(uint32_t w, uint32_t dec) {
  return w - (dec & nib_nonzero(w) & ~nib_saturated(w));
}

// Bit b of a byte to bit 4b: one byte of variants.py expand_mask_words.
__device__ __forceinline__ uint32_t spread_byte(uint32_t x) {
  x = (x | (x << 12)) & 0x000F000Fu;
  x = (x | (x << 6)) & 0x03030303u;
  return (x | (x << 3)) & kNibLsb;
}

// Launch arguments, carried through the host-side dispatch; the kernels
// take them as separate parameters so that the read-only pointers keep
// their __restrict__ (and the loads their read-only path).
struct UpdateArgs {
  const uint2* keys;
  const int32_t* member;
  const uint8_t* valid;
  uint32_t* counters;
  const uint32_t* salts;
  int64_t n;
  uint64_t member_words;
  uint32_t block_mask;
  int k, op;
};

struct ContainsArgs {
  const uint2* keys;
  const int32_t* member;
  const uint32_t* counters;
  bool* out;
  const uint32_t* salts;
  int64_t n;
  uint64_t member_words;
  uint32_t block_mask;
  int k;
};

// First counter word of key i's row (4S words a block); a bank adds the
// member's offset for a live key.
template <int S, bool BANK>
__device__ __forceinline__ uint64_t counter_row(const int32_t* member,
                                                uint64_t member_words,
                                                int64_t i, bool live,
                                                uint32_t h_blk,
                                                uint32_t block_mask) {
  uint64_t start = uint64_t(h_blk & block_mask) * uint64_t(4 * S);
  if constexpr (BANK) {
    if (live) start += uint64_t(uint32_t(member[i])) * member_words;
  }
  return start;
}

template <int S, bool BANK>
__global__ void __launch_bounds__(kThreads)
    counting_update_kernel(const uint2* __restrict__ keys,
                           const int32_t* __restrict__ member,
                           const uint8_t* __restrict__ valid,
                           uint32_t* counters,
                           const uint32_t* __restrict__ salts, int64_t n,
                           uint64_t member_words, uint32_t block_mask, int k,
                           int op) {
  __shared__ uint32_t smem[3 * kMaxSalts];
  stage_salts(smem, salts);
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n || (valid != nullptr && valid[i] == 0)) return;
  uint32_t h_pat, h_blk;
  hash_key(keys[i], h_pat, h_blk);
  uint32_t m[S];
  build_mask<S>(m, h_pat, smem, smem + kMaxSalts, smem + 2 * kMaxSalts, kSbf,
                k, 1, 0);
  uint32_t* row = counters + counter_row<S, BANK>(member, member_words, i,
                                                  true, h_blk, block_mask);
#pragma unroll
  for (int j = 0; j < S; ++j) {
#pragma unroll 1
    for (int c = 0; c < 4; ++c) {
      const uint32_t byte = (m[j] >> (8 * c)) & 0xFFu;
      if (byte == 0u) continue;
      const uint32_t inc = spread_byte(byte);
      uint32_t* p = row + 4 * j + c;
      uint32_t cur = __ldcg(p);
      while (true) {
        const uint32_t next =
            op == kAdd ? sat_inc_word(cur, inc) : guard_dec_word(cur, inc);
        if (next == cur) break;
        const uint32_t seen = atomicCAS(p, cur, next);
        if (seen == cur) break;
        cur = seen;
      }
    }
  }
}

// The nibble increments one key makes in counter word `word` of its row:
// byte word & 3 of logical word word >> 2 of its sbf-placed mask
// (build_mask, kSbf: salts j, j + S, ... land in word j), bit b of the
// byte as nibble b = 1 (spread_byte of the byte).
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

// The CAS loop of one counter word: the same order-free update as
// counting_update_kernel's.
template <int OP>
__device__ __forceinline__ void cas_word(uint32_t* p, uint32_t inc) {
  uint32_t cur = __ldcg(p);
  while (true) {
    const uint32_t next =
        OP == kAdd ? sat_inc_word(cur, inc) : guard_dec_word(cur, inc);
    if (next == cur) break;
    const uint32_t seen = atomicCAS(p, cur, next);
    if (seen == cur) break;
    cur = seen;
  }
}

// The global kernel's lanes: a lane a counter word of the row (L lanes a
// row, W words a lane, G rows a warp at once).
template <int S>
struct RowLanes {
  static constexpr int L = 4 * S < 32 ? 4 * S : 32;
  static constexpr int W = 4 * S / L;
  static constexpr int G = 32 / L;
};

// The grouped kernel's lanes: a lane a logical word of the row, its 4
// counter words one 16-byte load (S lanes a row, G rows a warp at once),
// and U rows a group loads before it updates them.
template <int S>
struct GroupLanes {
  static constexpr int G = 32 / S;
  static constexpr int U = 2;
};

// The nibble increments one key makes in the 4 counter words of logical
// word j of its row (inc[c]: byte c of the sbf-placed mask word j, spread).
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

// One CTA a segment of `rows` counter rows (4S words each): chunks of
// kGroupChunk slots, each counting-sorted by row in shared memory, then a
// group of L lanes a touched row (comment at the top).
template <int S, int OP>
__global__ void __launch_bounds__(kGroupThreads, 2)
    counting_partitioned_grouped_kernel(const uint2* __restrict__ keys,
                                        const uint8_t* __restrict__ valid,
                                        uint32_t* __restrict__ counters,
                                        const uint32_t* __restrict__ salts,
                                        int64_t capacity, uint32_t seg_cwords,
                                        uint32_t block_mask, int k,
                                        uint32_t rows) {
  using R = GroupLanes<S>;
  constexpr int kGroups = kGroupThreads / 32 * R::G;
  __shared__ uint32_t salt[3 * kMaxSalts];
  __shared__ uint32_t sums[32];
  extern __shared__ uint32_t dyn[];
  uint32_t* hist = dyn;               // rows: counts, then run ends
  uint32_t* spat = dyn + rows;        // the chunk's h_pat, sorted by row
  stage_salts(salt, salts);
  const int lane = threadIdx.x & 31, gl = lane % S;
  const int group = int(threadIdx.x >> 5) * R::G + lane / S;
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
    for (uint32_t r = threadIdx.x; r < rows; r += kGroupThreads) hist[r] = 0u;
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kGroupPer; ++t)
      if (row[t] != kNoRow) atomicAdd(&hist[row[t]], 1u);
    __syncthreads();
    block_exclusive_scan(hist, int(rows), sums);
#pragma unroll
    for (int t = 0; t < kGroupPer; ++t)
      if (row[t] != kNoRow) spat[atomicAdd(&hist[row[t]], 1u)] = pat[t];
    __syncthreads();
    // hist[r] is now the end of row r's run, hist[r - 1] its start. A group
    // takes U neighbouring rows at a time and loads all their words before
    // it updates them (U row requests in flight, not one).
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
        *reinterpret_cast<uint4*>(own + (r0 + u) * uint32_t(4 * S) +
                                  4 * gl) =
            make_uint4(apply_counts<OP>(old[u].x, cnt[0]),
                       apply_counts<OP>(old[u].y, cnt[1]),
                       apply_counts<OP>(old[u].z, cnt[2]),
                       apply_counts<OP>(old[u].w, cnt[3]));
      }
    }
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

template <int S, int PHI, int DEPTH, bool BANK>
__global__ void __launch_bounds__(kThreads)
    counting_contains_kernel(const uint2* __restrict__ keys,
                             const int32_t* __restrict__ member,
                             const uint32_t* __restrict__ counters,
                             bool* __restrict__ out,
                             const uint32_t* __restrict__ salts, int64_t n,
                             uint64_t member_words, uint32_t block_mask,
                             int k) {
  static_assert(PHI == 1 || PHI == 2 || PHI == 4, "PHI must divide 4");
  __shared__ uint32_t smem[3 * kMaxSalts];
  stage_salts(smem, salts);

  const int64_t base =
      int64_t(blockIdx.x) * (kThreads * DEPTH) + threadIdx.x;
  uint32_t m[DEPTH][S];
  const uint32_t* row[DEPTH];
  bool alive[DEPTH];
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) {
    const int64_t i = base + int64_t(d) * kThreads;
    alive[d] = i < n;
    uint32_t h_pat = 0u, h_blk = 0u;
    if (alive[d]) hash_key(keys[i], h_pat, h_blk);
    build_mask<S>(m[d], h_pat, smem, smem + kMaxSalts, smem + 2 * kMaxSalts,
                  kSbf, k, 1, 0);
    row[d] = counters + counter_row<S, BANK>(member, member_words, i,
                                             alive[d], h_blk, block_mask);
  }
#pragma unroll
  for (int j = 0; j < S; ++j) {
#pragma unroll
    for (int c = 0; c < 4 / PHI; ++c) {
      uint32_t w[DEPTH][PHI];
#pragma unroll
      for (int d = 0; d < DEPTH; ++d) {
        uint32_t chunk = m[d][j];
        if constexpr (PHI < 4)
          chunk = (chunk >> (8 * c * PHI)) & ((1u << (8 * PHI)) - 1u);
        if (alive[d] && chunk != 0u) {
          Vec<PHI>::load(row[d] + 4 * j + c * PHI, w[d]);
        } else {
#pragma unroll
          for (int p = 0; p < PHI; ++p) w[d][p] = 0u;
        }
      }
#pragma unroll
      for (int d = 0; d < DEPTH; ++d) {
#pragma unroll
        for (int p = 0; p < PHI; ++p) {
          const uint32_t inc =
              spread_byte((m[d][j] >> (8 * (c * PHI + p))) & 0xFFu);
          if ((nib_nonzero(w[d][p]) & inc) != inc) alive[d] = false;
        }
      }
    }
    bool any = false;
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) any |= alive[d];
    if (!any) break;
  }
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) {
    const int64_t i = base + int64_t(d) * kThreads;
    if (i < n) out[i] = alive[d];
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

template <int S, bool BANK>
int launch_update(const UpdateArgs& a, cudaStream_t stream) {
  const unsigned grid = unsigned((a.n + kThreads - 1) / kThreads);
  counting_update_kernel<S, BANK><<<grid, kThreads, 0, stream>>>(
      a.keys, a.member, a.valid, a.counters, a.salts, a.n, a.member_words,
      a.block_mask, a.k, a.op);
  return int(cudaGetLastError());
}

template <bool BANK>
int update_entry(int s, const UpdateArgs& a, cudaStream_t st) {
  if (a.op != kAdd && a.op != kRemove) return -1;
  switch (s) {
    case 1:
      return launch_update<1, BANK>(a, st);
    case 2:
      return launch_update<2, BANK>(a, st);
    case 4:
      return launch_update<4, BANK>(a, st);
    case 8:
      return launch_update<8, BANK>(a, st);
    case 16:
      return launch_update<16, BANK>(a, st);
    case 32:
      return launch_update<32, BANK>(a, st);
  }
  return -1;
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

template <int S, int PHI, int DEPTH, bool BANK>
int launch_contains(const ContainsArgs& a, cudaStream_t stream) {
  const int64_t per_cta = int64_t(kThreads) * DEPTH;
  const unsigned grid = unsigned((a.n + per_cta - 1) / per_cta);
  counting_contains_kernel<S, PHI, DEPTH, BANK>
      <<<grid, kThreads, 0, stream>>>(a.keys, a.member, a.counters, a.out,
                                      a.salts, a.n, a.member_words,
                                      a.block_mask, a.k);
  return int(cudaGetLastError());
}

template <int S, int PHI, bool BANK>
int dispatch_depth(int depth, const ContainsArgs& a, cudaStream_t st) {
  // contains_vmem runs DEPTH = 1 at any PHI; contains_hbm and the bank
  // contains run PHI = 4 at any DEPTH, with at most kMaxInFlight mask words
  // per thread
  constexpr bool kDeep = PHI == 4;
  if (depth > 1 && !kDeep) return -1;
  switch (depth) {
    case 1:
      return launch_contains<S, PHI, 1, BANK>(a, st);
    case 2:
      if constexpr (kDeep && 2 * S <= kMaxInFlight)
        return launch_contains<S, PHI, 2, BANK>(a, st);
      break;
    case 4:
      if constexpr (kDeep && 4 * S <= kMaxInFlight)
        return launch_contains<S, PHI, 4, BANK>(a, st);
      break;
    case 8:
      if constexpr (kDeep && 8 * S <= kMaxInFlight)
        return launch_contains<S, PHI, 8, BANK>(a, st);
      break;
  }
  return -1;
}

template <int S, bool BANK>
int dispatch_phi(int phi, int depth, const ContainsArgs& a, cudaStream_t st) {
  switch (phi) {
    case 1:
      if constexpr (!BANK) return dispatch_depth<S, 1, BANK>(depth, a, st);
      break;
    case 2:
      if constexpr (!BANK) return dispatch_depth<S, 2, BANK>(depth, a, st);
      break;
    case 4:
      return dispatch_depth<S, 4, BANK>(depth, a, st);
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

}  // namespace

extern "C" {

// keys: (n, 2) int32 [hi, lo], 8-byte aligned; valid: (n,) uint8 or null
// (every key valid); counters: (storage_words,) int32, 16-byte aligned;
// salts: (3, 96) int32; op: 0 add, 1 remove.
int counting_update(const void* keys, const void* valid, void* counters,
                    const void* salts, long long n, unsigned block_mask,
                    int s, int k, int op, void* stream) {
  const UpdateArgs a{static_cast<const uint2*>(keys), nullptr,
                     static_cast<const uint8_t*>(valid),
                     static_cast<uint32_t*>(counters),
                     static_cast<const uint32_t*>(salts), n, 0u, block_mask,
                     k, op};
  return update_entry<false>(s, a, static_cast<cudaStream_t>(stream));
}

// out: (n,) bool; phi in {1, 2, 4}; depth in {1, 2, 4, 8}.
int counting_contains(const void* keys, const void* counters, void* out,
                      const void* salts, long long n, unsigned block_mask,
                      int s, int phi, int depth, int k, void* stream) {
  const ContainsArgs a{static_cast<const uint2*>(keys), nullptr,
                       static_cast<const uint32_t*>(counters),
                       static_cast<bool*>(out),
                       static_cast<const uint32_t*>(salts), n, 0u, block_mask,
                       k};
  return contains_entry<false>(s, phi, depth, a,
                               static_cast<cudaStream_t>(stream));
}

// Bank forms. member: (n,) int32 in [0, B); counters: the
// (B, member_words) bank, 16-byte aligned, member_words = 4 n_words.
int counting_bank_update(const void* keys, const void* member,
                         const void* valid, void* counters, const void* salts,
                         long long n, unsigned long long member_words,
                         unsigned block_mask, int s, int k, int op,
                         void* stream) {
  const UpdateArgs a{static_cast<const uint2*>(keys),
                     static_cast<const int32_t*>(member),
                     static_cast<const uint8_t*>(valid),
                     static_cast<uint32_t*>(counters),
                     static_cast<const uint32_t*>(salts), n, member_words,
                     block_mask, k, op};
  return update_entry<true>(s, a, static_cast<cudaStream_t>(stream));
}

// phi must be 4; depth in {1, 2, 4, 8}.
int counting_bank_contains(const void* keys, const void* member,
                           const void* counters, void* out, const void* salts,
                           long long n, unsigned long long member_words,
                           unsigned block_mask, int s, int phi, int depth,
                           int k, void* stream) {
  const ContainsArgs a{static_cast<const uint2*>(keys),
                       static_cast<const int32_t*>(member),
                       static_cast<const uint32_t*>(counters),
                       static_cast<bool*>(out),
                       static_cast<const uint32_t*>(salts), n, member_words,
                       block_mask, k};
  return contains_entry<true>(s, phi, depth, a,
                              static_cast<cudaStream_t>(stream));
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
