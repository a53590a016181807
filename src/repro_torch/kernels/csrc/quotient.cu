// Counting quotient filter kernels for Hopper (sm_90a): bulk contains and the
// sorted-stream bulk add / remove, merge and resize.
//
// Replaces the Pallas entry points of repro/kernels/quotientfilter.py:
//   quotient_contains_kernel<SB>, or the binned contains (qf_tile_stats,
//   qf_scan_tables, bin8_count_kernel, bin_column_kernel, bin_scan_kernel,
//   bin8_scatter_kernel, qf_contains_bin<SB>)
//                                  <- contains_vmem (_contains_kernel, which
//                          runs core/quotient.py quotient_contains or
//                          quotient_contains_coop)
//   quotient_update (the kernels below, one stream of launches)
//                                  <- add_vmem and remove_vmem (_update_vmem,
//                          _update_kernel, which run quotient_insert_tile /
//                          quotient_remove_tile)
//
// Table. n_slots = 2^q slot lanes of SB (8, 16 or 32) bits, packed
// little-endian into u32 words: slot j is lane j % (32 / SB) of word
// j / (32 / SB). The top three lane bits are occupied (slot j is some
// fingerprint's home), continuation (same quotient as the slot before) and
// shifted (the element is not at its home); the low r bits the remainder.
// A fingerprint is the top p = q + r bits of xxh32(key, SEED_PATTERN) *
// SALTS[0]; its quotient fp >> r is the home slot.
//
// * quotient_contains_kernel: one thread a key, the classical cluster walk
//   (Bender et al.): if the home slot's occupied bit is clear the key is
//   absent; else walk left while the slot is shifted (the cluster start),
//   then forward one run for each occupied slot before q, and compare the
//   remainder along q's run (sorted, so it stops at the first larger one).
//   On a canonical table that is the reference's run-scan result, and it
//   reads only the key's own cluster; clusters may wrap past slot n - 1
//   (indices are taken mod n). Both coop values run this one kernel: the
//   TPU's tile-wide early exit has nothing to skip here. Bound: the bytes of
//   the keys and results, and the 32-byte sectors of the cluster each walk
//   reads (at most the table once).
// * the binned contains (row 22's redesign): for a batch large enough, the
//   keys are grouped by bin of 2^b quotients and each bin tests its keys
//   against the slots that hold its runs, staged in shared memory; no key
//   walks and nothing is indexed by slot. The reference defines the result
//   by ranks (core/quotient.py): past the first empty slot a0 no cluster
//   wraps, and a key's run is the run whose rank equals its home's occupied
//   rank. In absolute order the home of occupied rank o owns the run of
//   rank (o + W) mod D (D runs, W = run starts less occupied slots before
//   a0), so a bin [Q0, Q0 + B) whose homes have occupied ranks [k0, k1)
//   owns the runs (k0 + W) ... (k1 - 1 + W) mod D, and the first
//   skip = (k0 + W - R(Q0)) mod D run starts at or past Q0 belong to runs
//   homed before it (R(Q0): run starts before Q0). Per internal batch of at
//   most `batch` keys:
//   1-2. qf_tile_stats, qf_scan_tables (the update's stages 1-2, once a
//      call, with a tile a bin): each bin's exclusive counts of run starts
//      and occupied slots (k0 and R(Q0) are read off), D and W;
//   3-6. bin8_count_kernel, bin_column_kernel, bin_scan_kernel,
//      bin8_scatter_kernel (bin_common.cuh): each key's 8-byte slot
//      (fingerprint << 32 | index in the batch) into its bin's slice, each
//      bin's open sector staged in shared memory;
//   7. qf_contains_bin<SB>: one CTA a bin copies `window` words of the table
//      from the bin's first slot into shared memory (16-byte cp.async),
//      then scans the window a word (32 / SB slots) a thread, 512 words a
//      step: warp shuffles gather the occupied bits of [Q0, Q0 + B), and a
//      warp scan and the warps' counts rank each run start from Q0 on;
//      the (skip + j)-th is the start of the bin's j-th run (one slot a
//      thread, with ballots, took 2 us a step: 48 steps a bin at q26). It
//      stops once the bin's homes are
//      counted and all their runs found. A key's home gives its occupied
//      rank j (a popcount over the bits), its run starts at run_start[j],
//      and its remainder is compared along the run (sorted). A slot past
//      the window (long clusters: a load near 1, or a run that starts past
//      the window) is read through __ldg, so the result never depends on
//      the window. Bound: per batch the keys read twice, 8 B a slot written
//      and read, the table's windows read once, the results written once;
//      the tile pass reads the table once a call.
//   The cluster walk's cost grows with the batch and the load (1 / (1 -
//   load)^2 a key), the binned contains' with the batch and the table: the
//   host rule (quotientfilter.choose_contains_path) picks one from the
//   batch, the table and its load. qf_load_sample (quotient_load_sample)
//   counts the slots in use of 128 runs of at most 2048 slots spread over
//   the table; the host reads that count back once a table state.
// * the update: the words are a function of the stored fingerprint
//   multiset, and the flags of the batch order only (an add admits the
//   first room = n_slots - 1 - stored valid keys; a remove finds a key when
//   its rank among the batch's requests for its fingerprint is below the
//   stored count). One rebuild a call gives the reference's table and flags
//   for every tile. It works on streams indexed by element, sorted by
//   fingerprint, and never makes an array indexed by slot. Eleven kernels
//   a pass of at most 2^24 keys:
//    1. qf_tile_stats: per table tile (tile_slots slots) the slots in use,
//       run starts and occupied slots, its first empty slot and whether its
//       first slot continues a run; and each key chunk's valid count;
//    2. qf_scan_tables (one block): the tiles' exclusive counts, the stored
//       count m0, the runs D, the first empty slot a0, W = run starts less
//       occupied slots before a0 (the runs that wrap past slot n - 1 into
//       [0, a0)), and the slot s_W of the W-th run start (the first run
//       homed at or before a0, the smallest fingerprint); the chunks'
//       valid prefix;
//    3. qf_decode: each tile turns its slots into fingerprints in order. A
//       slot's run has absolute rank x (run starts up to it, less one), its
//       home is the occupied slot of rank (x - W) mod D: the tile walks the
//       occupied bits from the tile that holds its first rank (found by a
//       search over the tiles' counts) and keeps its runs' homes in shared
//       memory. The element goes to place (in use before it - in use before
//       s_W) mod m0 of the old stream, which is then sorted by fingerprint;
//    4-7. the batch: qf_bin_count (admission, from the chunks' valid
//       prefix; flags; each chunk's count of admitted keys by bin, the
//       fingerprint's top b bits), qf_bin_offsets (one block: each (chunk,
//       bin)'s place), qf_bin_scatter (sort keys to their bin: an add's
//       fingerprint, a remove's fp << 32 | index) and qf_bin_sort (each
//       bin in shared memory: a counting sort into sub-buckets by the next
//       11 fingerprint bits, then an insertion sort of each; a bitonic
//       network for a bin of repeated fingerprints, in device memory for a
//       bin past the cap). No library sort or scan;
//    8. qf_merge_tiles (one thread a merge tile, all at once): its
//       merge-path splits and, for a remove, the whole streams' bounds of
//       its first and last fingerprint; qf_merge: tiles of merge_tile
//       merged elements (the old stream first on equal fingerprints), each
//       thread walking its share of the merged order from its own split.
//       An add keeps every element; a remove drops an old copy whose rank
//       in its group is below the group's requests, and finds a request
//       whose rank (batch order: the index breaks ties) is below the
//       group's stored copies, the ranks read off the walk. The kept
//       elements' places come from a decoupled look-back over the tiles'
//       counts (remove).
//       Each element is a candidate for the anchor, the first argmin of
//       P = cumsum(cnt - 1): P at q - 1 is k - q for the first element k of
//       quotient q, so the least (k - q, q - 1) over all elements, with
//       (m1 - n_slots, n_slots - 1), is the anchor A and tells sA, the first
//       element homed past A. A stays empty and no run crosses it;
//    9. qf_positions: from element sA on (rotated order), tiles with a
//       decoupled look-back of the max-plus scan: pos_j = j + cummax(u_j -
//       j), u_j the rotated home. Each element's position with its
//       continuation and shifted bits (one u32), and for each table tile
//       the first element at or past its rotated start, by position and
//       by home (two small tables);
//   10. qf_write: each table tile puts its words together in shared memory
//       from the element ranges those tables give (remainders and flag
//       bits at their positions, occupied bits at the homes) and stores
//       each word once: no atomics into device memory, no memset, no copy.
//   Bound: the bytes of the keys, valid bytes and flags, and the table read
//   once and written once. The design moves more: the keys twice, the sort
//   keys four times, the old stream twice, the new stream three times, the
//   positions twice and the table three times (chip_smoke.py
//   quotient_update_floor_ms).
// * merge and resize (not TPU kernels: the JAX package computes them
//   outside Pallas) run the same stages without the batch: merge decodes
//   both tables (1-3 twice) and merges the two streams as an add (8-10);
//   resize decodes one table (1-3) and writes the same stream with the new
//   q / r split (8-10: the order is the same, so nothing is sorted).
//
// C interface for ctypes: each entry point returns the first CUDA error of
// its launches (0 when all launched), or -1 for arguments it does not take.

#include <cstring>
#include <type_traits>

#include "bin_common.cuh"

namespace {

struct Geometry {
  uint32_t mask;       // n_slots - 1
  int r_bits;
  int p_bits;          // q + r
  uint32_t fp_salt;
};

template <int SB>
struct Lanes {
  static constexpr int SPW = 32 / SB;
  static constexpr uint32_t kLane =
      SB == 32 ? 0xFFFFFFFFu : (1u << (SB % 32)) - 1u;
  static constexpr uint32_t kOcc = 1u << (SB - 1);
  static constexpr uint32_t kCont = 1u << (SB - 2);
  static constexpr uint32_t kShift = 1u << (SB - 3);
  static constexpr uint32_t kMeta = kOcc | kCont | kShift;

  __device__ __forceinline__ static uint32_t get(const uint32_t* __restrict__ t,
                                                 uint32_t s) {
    if (SPW == 1) return __ldg(t + s);
    return (__ldg(t + s / SPW) >> (SB * (s % SPW))) & kLane;
  }
};

__device__ __forceinline__ uint32_t fingerprint(uint2 key, const Geometry& g) {
  const uint32_t h = xxh32_from_products(key.y * P3, key.x * P3, kSeedPattern);
  return (h * g.fp_salt) >> (32 - g.p_bits);
}

__device__ __forceinline__ uint32_t rem_mask(const Geometry& g) {
  return (1u << g.r_bits) - 1u;
}

// rem is in the run that starts at slot s (remainders ascending)
template <int SB>
__device__ __forceinline__ bool run_holds(const uint32_t* __restrict__ t,
                                          uint32_t s, uint32_t rem,
                                          const Geometry& g) {
  using L = Lanes<SB>;
  uint32_t v = L::get(t, s);
  while (true) {
    const uint32_t rv = v & rem_mask(g);
    if (rv >= rem) return rv == rem;
    s = (s + 1u) & g.mask;
    v = L::get(t, s);
    if (!(v & L::kCont)) return false;
  }
}

// ---------------------------------------------------------------------------
// contains
// ---------------------------------------------------------------------------

// the cluster walk of one key
template <int SB>
__device__ __forceinline__ bool walk_holds(const uint32_t* __restrict__ table,
                                           uint2 key, const Geometry& g) {
  using L = Lanes<SB>;
  const uint32_t fp = fingerprint(key, g);
  const uint32_t q = fp >> g.r_bits, rem = fp & rem_mask(g);
  bool hit = false;
  if (L::get(table, q) & L::kOcc) {
    uint32_t b = q;
    while (L::get(table, b) & L::kShift) b = (b - 1u) & g.mask;
    uint32_t s = b;                       // cluster start: b's own run
    while (b != q) {                      // one run for each occupied slot
      do {
        s = (s + 1u) & g.mask;
      } while (L::get(table, s) & L::kCont);
      do {
        b = (b + 1u) & g.mask;
      } while (!(L::get(table, b) & L::kOcc));
    }
    hit = run_holds<SB>(table, s, rem, g);
  }
  return hit;
}

// one thread a key
template <int SB>
__global__ void __launch_bounds__(kThreads)
    quotient_contains_kernel(const uint2* __restrict__ keys,
                             const uint32_t* __restrict__ table,
                             bool* __restrict__ out, int64_t n, Geometry g) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) out[i] = walk_holds<SB>(table, keys[i], g);
}

#define QF_CHECK()                                   \
  do {                                               \
    const cudaError_t e_ = cudaGetLastError();       \
    if (e_ != cudaSuccess) return int(e_);           \
  } while (0)

unsigned grid_of(long long n) {
  return unsigned((n + kThreads - 1) / kThreads);
}

// ---------------------------------------------------------------------------
// The update: block-wide helpers
// ---------------------------------------------------------------------------

constexpr int kTileThreads = 512;      // table-tile kernels (1-3, 10)
constexpr int kKeyThreads = 1024;      // key stages (4-7) and one-block scans
constexpr int kMergeThreads = 256;     // merge (8)
constexpr int kPosThreads = 512;       // positions (9)
constexpr int kMaxTile = 4096;         // most slots or merged elements a tile
constexpr int kMaxItems = kMaxTile / kPosThreads;
constexpr int kKeyChunks = 256;        // quotientfilter.KEY_CHUNKS
constexpr int kMaxBinBits = 12;        // quotientfilter.MAX_BIN_BITS
constexpr int kBinCap = 8192;          // quotientfilter.BIN_CAP
constexpr long long kKeyBatch = 1ll << 24;   // quotientfilter.KEY_BATCH
constexpr uint32_t kNone = 0xFFFFFFFFu;
constexpr int kNeg = -(1 << 30);       // below every u - j (n_slots <= 2^29)
constexpr uint32_t kPosMask = (1u << 30) - 1u;

// scalars of a decoded table (16 u64 each; a merge's second table uses the
// next 16), and of the rebuild (in the first table's)
enum Scal : int {
  kM0 = 0,        // stored fingerprints
  kD = 1,         // runs
  kW = 2,         // runs that wrap past the last slot
  kBase = 3,      // in-use slots before s_W
  kRoom = 4,      // n_slots - 1 - m0 (add)
  kNb = 5,        // admitted keys of the batch
  kAnchor = 6,    // least (k - q + n_slots) << 32 | (q - 1)
  kM1 = 7,        // fingerprints of the new table
  kMergeTicket = 8,
  kPosTicket = 9,
  kScalN = 16,
};

struct AddF {
  template <class T>
  __device__ T operator()(T a, T b) const { return a + b; }
};
struct MinF {
  template <class T>
  __device__ T operator()(T a, T b) const { return b < a ? b : a; }
};
struct MaxF {
  template <class T>
  __device__ T operator()(T a, T b) const { return a < b ? b : a; }
};

template <class T, class F>
__device__ __forceinline__ T warp_incl(T v, F f) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(0xFFFFFFFFu, v, d);
    if (lane >= d) v = f(y, v);
  }
  return v;
}

// Exclusive scan of one value a thread over the block (blockDim a multiple
// of 32); *total gets the block's combine. Every thread must call it.
template <class T, class F>
__device__ T block_excl(T v, T id, F f, T* total) {
  __shared__ T wsum[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const T inc = warp_incl(v, f);
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T w = lane < nw ? wsum[lane] : id;
    w = warp_incl(w, f);
    wsum[lane] = w;
  }
  __syncthreads();
  T lane_excl = __shfl_up_sync(0xFFFFFFFFu, inc, 1);
  if (lane == 0) lane_excl = id;
  const T res = f(warp == 0 ? id : wsum[warp - 1], lane_excl);
  *total = wsum[nw - 1];
  __syncthreads();                         // wsum is used again
  return res;
}

template <class T, class F>
__device__ __forceinline__ T block_all(T v, T id, F f) {
  T total;
  block_excl(v, id, f, &total);
  return total;
}

// In-place exclusive sum of a[0, n) by one block; returns the total.
__device__ unsigned long long block_scan_array(uint32_t* a, long long n) {
  unsigned long long carry = 0;
  for (long long c = 0; c < n; c += blockDim.x) {
    const long long i = c + threadIdx.x;
    const unsigned long long v = i < n ? a[i] : 0;
    unsigned long long tot;
    const unsigned long long e = block_excl(v, 0ull, AddF{}, &tot);
    if (i < n) a[i] = uint32_t(carry + e);
    carry += tot;
  }
  return carry;
}

__device__ __forceinline__ long long pmod(long long a, long long m) {
  const long long r = a % m;
  return r < 0 ? r + m : r;
}

// the last index t of a[0, n) with a[t] <= x (a non-decreasing, a[0] <= x)
__device__ long long last_le(const uint32_t* a, long long n,
                             unsigned long long x) {
  long long lo = 0, hi = n;           // a[lo] <= x < a[hi]
  while (hi - lo > 1) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid; else hi = mid;
  }
  return lo;
}

// ---------------------------------------------------------------------------
// The update, stages 1-3: table tiles, their scan, the decode
// ---------------------------------------------------------------------------

// 1. Per table tile: in use, run starts, occupied (packed 21 bits each),
// the first empty slot (kNone: none) and whether its first slot continues
// a run. Blocks from n_tiles on count a key chunk's valid bytes.
template <int SB>
__global__ void __launch_bounds__(kTileThreads)
    qf_tile_stats(const uint32_t* __restrict__ t, uint32_t mask, int ts,
                  long long nt, uint32_t* __restrict__ tu,
                  uint32_t* __restrict__ tr, uint32_t* __restrict__ to,
                  uint32_t* __restrict__ te, uint32_t* __restrict__ tcf,
                  const uint8_t* __restrict__ valid, long long n,
                  int chunks, uint32_t* __restrict__ chunk_valid) {
  using L = Lanes<SB>;
  if (blockIdx.x >= nt) {                   // a key chunk's valid count
    const long long c = blockIdx.x - nt;
    const long long k0 = c * n / chunks, k1 = (c + 1) * n / chunks;
    unsigned long long cnt = 0;
    for (long long i = k0 + threadIdx.x; i < k1; i += blockDim.x)
      cnt += valid[i] != 0;
    cnt = block_all(cnt, 0ull, AddF{});
    if (threadIdx.x == 0) chunk_valid[c] = uint32_t(cnt);
    return;
  }
  const long long base = (long long)blockIdx.x * ts;
  unsigned long long packed = 0, first = kNone;
  if (ts % L::SPW == 0) {                   // a word's lanes at once
    for (int w = threadIdx.x; w < ts / L::SPW; w += blockDim.x) {
      const uint32_t word = __ldg(t + base / L::SPW + w);
#pragma unroll
      for (int j = 0; j < L::SPW; ++j) {
        const uint32_t l = (word >> (SB * j)) & L::kLane;
        const bool used = l & L::kMeta;
        packed += ((unsigned long long)used << 42) |
                  ((unsigned long long)(used && !(l & L::kCont)) << 21) |
                  (unsigned long long)((l & L::kOcc) != 0);
        const unsigned long long s = base + w * L::SPW + j;
        if (!used && s < first) first = s;
      }
    }
  } else {
    for (int s = threadIdx.x; s < ts; s += blockDim.x) {
      const uint32_t l = L::get(t, uint32_t(base + s));
      const bool used = l & L::kMeta;
      packed += ((unsigned long long)used << 42) |
                ((unsigned long long)(used && !(l & L::kCont)) << 21) |
                (unsigned long long)((l & L::kOcc) != 0);
      if (!used && (unsigned long long)(base + s) < first) first = base + s;
    }
  }
  packed = block_all(packed, 0ull, AddF{});
  first = block_all(first, (unsigned long long)kNone, MinF{});
  if (threadIdx.x == 0) {
    const uint32_t l0 = L::get(t, uint32_t(base));
    tu[blockIdx.x] = uint32_t(packed >> 42);
    tr[blockIdx.x] = uint32_t((packed >> 21) & 0x1FFFFF);
    to[blockIdx.x] = uint32_t(packed & 0x1FFFFF);
    te[blockIdx.x] = uint32_t(first);
    tcf[blockIdx.x] = (l0 & L::kMeta) && (l0 & L::kCont);
  }
}

// counts of (in use, run start, occupied) in slots [lo, hi) of the table,
// packed as in qf_tile_stats, by one block
template <int SB>
__device__ unsigned long long count_slots(const uint32_t* t, long long lo,
                                          long long hi) {
  using L = Lanes<SB>;
  unsigned long long packed = 0;
  for (long long s = lo + threadIdx.x; s < hi; s += blockDim.x) {
    const uint32_t l = L::get(t, uint32_t(s));
    const bool used = l & L::kMeta;
    packed += ((unsigned long long)used << 42) |
              ((unsigned long long)(used && !(l & L::kCont)) << 21) |
              (unsigned long long)((l & L::kOcc) != 0);
  }
  return block_all(packed, 0ull, AddF{});
}

// 2. One block: the tiles' exclusive counts in place, the table's scalars,
// the chunks' valid prefix; with `init`, the rebuild's state (scalars,
// look-back flags, tile-start tables).
template <int SB>
__global__ void __launch_bounds__(kTileThreads)
    qf_scan_tables(const uint32_t* __restrict__ t, uint32_t mask, int ts,
                   long long nt, uint32_t* tu, uint32_t* tr, uint32_t* to,
                   const uint32_t* __restrict__ te,
                   unsigned long long* scal, uint32_t* chunk_valid,
                   int chunks, int init, unsigned long long* rebuild,
                   unsigned long long* st_merge, long long merge_tiles,
                   unsigned long long* st_pos, long long pos_tiles,
                   uint32_t* fpos, uint32_t* fhome, long long nt_out) {
  __shared__ long long s_sw;
  const long long n_slots = (long long)mask + 1;
  const unsigned long long m0 = block_scan_array(tu, nt);
  const unsigned long long d = block_scan_array(tr, nt);
  block_scan_array(to, nt);
  unsigned long long a0 = kNone;
  for (long long i = threadIdx.x; i < nt; i += blockDim.x)
    a0 = te[i] < a0 ? te[i] : a0;
  a0 = block_all(a0, (unsigned long long)kNone, MinF{});
  long long uexa = 0, rexa = 0, oexa = 0;
  if (a0 != kNone) {                      // counts before a0 in its tile
    const long long t0 = (long long)a0 / ts;
    const unsigned long long c = count_slots<SB>(t, t0 * ts, (long long)a0);
    uexa = tu[t0] + (c >> 42);
    rexa = tr[t0] + ((c >> 21) & 0x1FFFFF);
    oexa = to[t0] + (c & 0x1FFFFF);
  }
  const long long w = rexa - oexa;
  long long base = uexa;
  if (w < rexa) {                         // the W-th run start: s_W
    __shared__ long long s_tw;
    if (threadIdx.x == 0) {
      s_tw = last_le(tr, nt, (unsigned long long)w);
      s_sw = -1;
    }
    __syncthreads();
    const long long tw = s_tw;
    unsigned long long carry = 0;
    for (int c = 0; c < ts; c += blockDim.x) {
      const int s = c + threadIdx.x;
      const uint32_t l = s < ts ? Lanes<SB>::get(t, uint32_t(tw * ts + s))
                                : 0u;
      const bool used = l & Lanes<SB>::kMeta;
      const bool run = used && !(l & Lanes<SB>::kCont);
      unsigned long long tot;
      const unsigned long long e = block_excl(
          ((unsigned long long)used << 32) | (unsigned long long)run, 0ull,
          AddF{}, &tot);
      if (run && tr[tw] + ((carry + e) & 0xFFFFFFFF) == (unsigned long long)w)
        s_sw = tu[tw] + ((carry + e) >> 32);
      carry += tot;
    }
    __syncthreads();
    base = s_sw;
  }
  if (threadIdx.x == 0) {
    scal[kM0] = m0;
    scal[kD] = d;
    scal[kW] = (unsigned long long)w;
    scal[kBase] = (unsigned long long)base;
    scal[kRoom] = m0 + 1 < (unsigned long long)n_slots ? n_slots - 1 - m0
                                                       : 0;
  }
  if (chunk_valid != nullptr) block_scan_array(chunk_valid, chunks);
  if (!init) return;
  if (threadIdx.x == 0) {
    rebuild[kNb] = 0;
    rebuild[kAnchor] = ~0ull;
    rebuild[kM1] = 0;
    rebuild[kMergeTicket] = 0;
    rebuild[kPosTicket] = 0;
  }
  for (long long i = threadIdx.x; i < merge_tiles; i += blockDim.x)
    st_merge[i] = 0;
  for (long long i = threadIdx.x; i < pos_tiles; i += blockDim.x)
    st_pos[i] = 0;
  for (long long i = threadIdx.x; i <= nt_out; i += blockDim.x)
    fpos[i] = fhome[i] = kNone;
}

// 3. Each tile's stored fingerprints, to their places in the sorted stream
template <int SB>
__global__ void __launch_bounds__(kTileThreads)
    qf_decode(const uint32_t* __restrict__ t, uint32_t mask, int r_bits,
              int ts, long long nt, const uint32_t* __restrict__ uex,
              const uint32_t* __restrict__ rex,
              const uint32_t* __restrict__ oex,
              const uint32_t* __restrict__ tcf,
              const unsigned long long* __restrict__ scal,
              uint32_t* __restrict__ out, long long cap) {
  using L = Lanes<SB>;
  extern __shared__ uint32_t qtab[];
  __shared__ long long s_u, s_covered;
  const long long m0 = (long long)scal[kM0], d = (long long)scal[kD];
  const long long tile = blockIdx.x;
  const long long u_t = (tile + 1 < nt ? uex[tile + 1] : m0) - uex[tile];
  if (u_t == 0 || d == 0) return;
  const long long w = (long long)scal[kW], base = (long long)scal[kBase];
  const int cf = tcf[tile];
  const long long r_t = (tile + 1 < nt ? rex[tile + 1] : d) - rex[tile];
  const long long k = r_t + cf < d ? r_t + cf : d;
  const long long o_lo = pmod((long long)rex[tile] - cf - w, d);
  // the homes of ranks o_lo .. o_lo + k - 1 (mod d): walk the occupied
  // bits from the tile that holds rank o_lo
  if (threadIdx.x == 0) {
    // usually this tile or the one before it holds rank o_lo
    auto holds = [&](long long u) {
      return u >= 0 && oex[u] <= o_lo && (u + 1 == nt || oex[u + 1] > o_lo);
    };
    const long long u = holds(tile) ? tile
                        : holds(tile - 1)
                            ? tile - 1
                            : last_le(oex, nt, (unsigned long long)o_lo);
    s_u = u;
    s_covered = (u + 1 < nt ? oex[u + 1] : d) - o_lo;
  }
  __syncthreads();
  // each thread takes `it` consecutive slots of a tile: one block scan a
  // tile
  const int it = (ts + blockDim.x - 1) / blockDim.x;
  const int s0 = threadIdx.x * it;
  const int s1 = s0 + it < ts ? s0 + it : ts;
  for (long long hops = 0; hops <= nt; ++hops) {   // a canonical table ends
    const long long u = s_u;                         // within one cycle
    unsigned long long cnt = 0;
    for (int s = s0; s < s1; ++s)
      cnt += (L::get(t, uint32_t(u * ts + s)) & L::kOcc) != 0;
    unsigned long long tot;
    unsigned long long rank = oex[u] + block_excl(cnt, 0ull, AddF{}, &tot);
    for (int s = s0; s < s1; ++s) {
      const uint32_t slot = uint32_t(u * ts + s);
      if (L::get(t, slot) & L::kOcc) {
        long long i = (long long)rank - o_lo;      // in (-d, d)
        if (i < 0) i += d;
        if (i < k) qtab[i] = slot;
        ++rank;
      }
    }
    const long long covered = s_covered;
    __syncthreads();                      // every thread read s_covered
    if (covered >= k) break;
    if (threadIdx.x == 0) {
      const long long v = (u + 1) % nt;
      s_u = v;
      s_covered = covered + (v + 1 < nt ? oex[v + 1] : d) - oex[v];
    }
    __syncthreads();
  }
  __syncthreads();
  const uint32_t rm = (1u << r_bits) - 1u;
  unsigned long long cnt = 0;             // (in use << 32 | run starts)
  for (int s = s0; s < s1; ++s) {
    const uint32_t l = L::get(t, uint32_t(tile * ts + s));
    const bool used = l & L::kMeta;
    cnt += ((unsigned long long)used << 32) |
           (unsigned long long)(used && !(l & L::kCont));
  }
  unsigned long long tot;
  unsigned long long at = block_excl(cnt, 0ull, AddF{}, &tot);
  for (int s = s0; s < s1; ++s) {
    const uint32_t l = L::get(t, uint32_t(tile * ts + s));
    const bool used = l & L::kMeta;
    const bool run = used && !(l & L::kCont);
    if (used) {
      const long long x = (long long)(at & 0xFFFFFFFF) + run - 1 + cf;
      const uint32_t q = qtab[x >= d ? x - d : x];
      long long idx = (long long)uex[tile] + (long long)(at >> 32) - base;
      if (idx < 0) idx += m0;                    // in [-m0, m0)
      if (idx < cap) out[idx] = (q << r_bits) | (l & rm);
    }
    at += ((unsigned long long)used << 32) | (unsigned long long)run;
  }
}

// ---------------------------------------------------------------------------
// The update, stages 4-7: admission, bins, the sort
// ---------------------------------------------------------------------------

template <int OP>
struct Admit {
  const uint8_t* valid;
  const uint32_t* chunk_valid;          // exclusive, after qf_scan_tables
  unsigned long long room;
  // rounds of blockDim keys from k0; returns whether key i is admitted
  // (carry: valid keys of the chunk before this round)
  __device__ bool operator()(long long i, long long k1, int chunk,
                             unsigned long long& carry, bool& v) const {
    v = i < k1 && (valid == nullptr || valid[i]);
    if (OP == 1) return v;
    if (valid == nullptr) return v && (unsigned long long)i < room;
    unsigned long long tot;
    const unsigned long long e = block_excl((unsigned long long)v, 0ull,
                                            AddF{}, &tot);
    const unsigned long long incl =
        valid == nullptr ? (unsigned long long)i + 1
                         : chunk_valid[chunk] + carry + e + v;
    carry += tot;
    return v && incl <= room;
  }
};

// 4. Admission, flags, and each chunk's admitted keys by bin (its column)
template <int OP>
__global__ void __launch_bounds__(kKeyThreads)
    qf_bin_count(const uint2* __restrict__ keys,
                 const uint8_t* __restrict__ valid, long long n, int chunks,
                 const uint32_t* __restrict__ chunk_valid,
                 const unsigned long long* __restrict__ scal,
                 bool* __restrict__ flags, uint32_t* __restrict__ hist,
                 int n_bins, int shift, Geometry g) {
  extern __shared__ uint32_t shist[];
  const int c = blockIdx.x;
  const long long k0 = c * n / chunks, k1 = (c + 1) * n / chunks;
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) shist[b] = 0;
  __syncthreads();
  const Admit<OP> admit{valid, chunk_valid, scal[kRoom]};
  unsigned long long carry = 0;
  for (long long r = k0; r < k1; r += blockDim.x) {
    const long long i = r + threadIdx.x;
    bool v;
    const bool ok = admit(i, k1, c, carry, v);
    if (i < k1) {
      if (OP == 0) flags[i] = ok || !v;
      else if (!v) flags[i] = true;       // a masked key is a no-op
    }
    if (ok) atomicAdd(shist + (fingerprint(keys[i], g) >> shift), 1u);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x)
    hist[(long long)c * n_bins + b] = shist[b];
}

// 5. One block: each bin's start (bin_off), each (chunk, bin)'s place in
// its bin (hist, in place), the admitted keys (scal[kNb])
__global__ void __launch_bounds__(kKeyThreads)
    qf_bin_offsets(uint32_t* hist, int chunks, int n_bins, uint32_t* bin_off,
                   unsigned long long* scal) {
  unsigned long long carry = 0;
  for (int c0 = 0; c0 < n_bins; c0 += blockDim.x) {
    const int b = c0 + threadIdx.x;
    unsigned long long col = 0;
    if (b < n_bins)
      for (int c = 0; c < chunks; ++c) col += hist[(long long)c * n_bins + b];
    unsigned long long tot;
    const unsigned long long e = block_excl(col, 0ull, AddF{}, &tot);
    if (b < n_bins) {
      unsigned long long at = carry + e;
      bin_off[b] = uint32_t(at);
      for (int c = 0; c < chunks; ++c) {
        const long long i = (long long)c * n_bins + b;
        const uint32_t h = hist[i];
        hist[i] = uint32_t(at);
        at += h;
      }
    }
    carry += tot;
  }
  if (threadIdx.x == 0) {
    bin_off[n_bins] = uint32_t(carry);
    scal[kNb] = carry;
  }
}

// The sort key of a batch element: an add needs the fingerprint alone (its
// words depend on the multiset only, its flags are set), a remove (fp << 32
// | index), the index ordering equal fingerprints in batch order.
template <int OP>
using SortKey = typename std::conditional<OP == 0, uint32_t,
                                          unsigned long long>::type;

// 6. The admitted keys' sort keys to their (chunk, bin) runs
template <int OP>
__global__ void __launch_bounds__(kKeyThreads)
    qf_bin_scatter(const uint2* __restrict__ keys,
                   const uint8_t* __restrict__ valid, long long n, int chunks,
                   const uint32_t* __restrict__ chunk_valid,
                   const unsigned long long* __restrict__ scal,
                   const uint32_t* __restrict__ hist, int n_bins, int shift,
                   Geometry g, SortKey<OP>* __restrict__ out) {
  extern __shared__ uint32_t cursor[];
  const int c = blockIdx.x;
  const long long k0 = c * n / chunks, k1 = (c + 1) * n / chunks;
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x)
    cursor[b] = hist[(long long)c * n_bins + b];
  __syncthreads();
  const Admit<OP> admit{valid, chunk_valid, scal[kRoom]};
  unsigned long long carry = 0;
  for (long long r = k0; r < k1; r += blockDim.x) {
    const long long i = r + threadIdx.x;
    bool v;
    if (admit(i, k1, c, carry, v)) {
      const uint32_t fp = fingerprint(keys[i], g);
      const uint32_t at = atomicAdd(cursor + (fp >> shift), 1u);
      out[at] = OP == 0 ? SortKey<OP>(fp)
                        : SortKey<OP>(((unsigned long long)fp << 32) |
                                      (unsigned long long)i);
    }
  }
}

template <class K>
__device__ __forceinline__ void cas(K* a, int lo, int hi) {
  const K x = a[lo], y = a[hi];
  if (y < x) {
    a[lo] = y;
    a[hi] = x;
  }
}

// Ascending sort of a[0, n) by one block: a bitonic network of the next
// power of two whose every comparator puts the smaller value low (each
// merge starts by comparing a block's halves mirrored), so the missing top
// elements act as +inf and their comparators are skipped.
template <class K>
__device__ void bitonic(K* a, int n) {
  int p2 = 1;
  while (p2 < n) p2 <<= 1;
  const int pairs = p2 >> 1;
  for (int k = 2; k <= p2; k <<= 1) {
    const int h = k >> 1;
    for (int i = threadIdx.x; i < pairs; i += blockDim.x) {
      const int blk = i / h, off = i - blk * h;
      const int hi = blk * k + k - 1 - off;
      if (hi < n) cas(a, blk * k + off, hi);
    }
    __syncthreads();
    for (int j = h >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < pairs; i += blockDim.x) {
        const int lo = (i / j) * 2 * j + (i % j);
        if (lo + j < n) cas(a, lo, lo + j);
      }
      __syncthreads();
    }
  }
}

// 7. Each bin sorted by (fp, index), in shared memory up to `cap` keys: a
// counting sort of the keys' indices into 2^11 sub-buckets by the next
// fingerprint bits below the bin's (rem_bits of them are left), then an
// insertion sort of each sub-bucket by one thread; a bin with a sub-bucket
// of more than kSubMax keys (repeated fingerprints) takes the bitonic
// network instead. A bin past `cap` sorts in place in device memory.
constexpr int kSubBits = 11;
constexpr int kSubMax = 32;

__host__ __device__ constexpr int sort_smem_bytes(int cap, int key_bytes) {
  return (cap * (key_bytes + 2) + 3) / 4 * 4 + 2 * (1 << kSubBits) * 4;
}

template <class K>
__global__ void __launch_bounds__(kKeyThreads)
    qf_bin_sort(K* keys, const uint32_t* __restrict__ bin_off, int cap,
                int rem_bits) {
  extern __shared__ unsigned long long sk8[];
  K* sk = reinterpret_cast<K*>(sk8);
  uint16_t* perm = reinterpret_cast<uint16_t*>(sk + cap);
  uint32_t* cur = reinterpret_cast<uint32_t*>(
      reinterpret_cast<char*>(sk) + sort_smem_bytes(cap, sizeof(K)) -
      2 * (1 << kSubBits) * 4);
  uint32_t* beg = cur + (1 << kSubBits);
  const long long lo = bin_off[blockIdx.x];
  const int size = int(bin_off[blockIdx.x + 1] - lo);
  if (size < 2) return;
  if (size > cap) {
    bitonic(keys + lo, size);
    return;
  }
  for (int i = threadIdx.x; i < size; i += blockDim.x) sk[i] = keys[lo + i];
  const int dbits = rem_bits < kSubBits ? rem_bits : kSubBits;
  const int shift = (sizeof(K) == 8 ? 32 : 0) + rem_bits - dbits;
  const uint32_t dmask = (1u << dbits) - 1u;
  const int n_sub = 1 << dbits;
  for (int d = threadIdx.x; d < n_sub; d += blockDim.x) cur[d] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < size; i += blockDim.x)
    atomicAdd(cur + (uint32_t(sk[i] >> shift) & dmask), 1u);
  __syncthreads();
  unsigned long long big = 0;
  for (int d = threadIdx.x; d < n_sub; d += blockDim.x)
    big = cur[d] > big ? cur[d] : big;
  big = block_all(big, 0ull, MaxF{});
  if (big > kSubMax) {
    bitonic(sk, size);
    for (int i = threadIdx.x; i < size; i += blockDim.x) keys[lo + i] = sk[i];
    return;
  }
  unsigned long long carry = 0;
  for (int c = 0; c < n_sub; c += blockDim.x) {
    const int d = c + threadIdx.x;
    unsigned long long tot;
    const unsigned long long e = block_excl(
        (unsigned long long)(d < n_sub ? cur[d] : 0u), 0ull, AddF{}, &tot);
    if (d < n_sub) beg[d] = cur[d] = uint32_t(carry + e);
    carry += tot;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < size; i += blockDim.x)
    perm[atomicAdd(cur + (uint32_t(sk[i] >> shift) & dmask), 1u)] =
        uint16_t(i);
  __syncthreads();
  for (int d = threadIdx.x; d < n_sub; d += blockDim.x) {
    const int b0 = beg[d], b1 = cur[d];
    for (int a = b0 + 1; a < b1; ++a) {
      const uint16_t x = perm[a];
      const K kx = sk[x];
      int b = a;
      while (b > b0 && sk[perm[b - 1]] > kx) {
        perm[b] = perm[b - 1];
        --b;
      }
      perm[b] = x;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < size; i += blockDim.x)
    keys[lo + i] = sk[perm[i]];
}

// ---------------------------------------------------------------------------
// The update, stages 8-10: merge, positions, write
// ---------------------------------------------------------------------------

// the batch stream: sorted keys (stride 2: index low, fp high) or a decoded
// stream (stride 1)
struct BStream {
  const uint32_t* p;
  int stride;
  __device__ __forceinline__ uint32_t fp(long long j) const {
    return p[j * stride + stride - 1];
  }
  __device__ __forceinline__ uint32_t index(long long j) const {
    return p[j * stride];
  }
};

// merge path: old elements among the first d merged (old first on ties)
__device__ long long merge_split(const uint32_t* o, long long m0, BStream b,
                                 long long nb, long long d) {
  long long lo = d - nb > 0 ? d - nb : 0, hi = d < m0 ? d : m0;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (b.fp(d - 1 - mid) < o[mid]) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// first index of [0, n) whose value is >= v (upper: > v)
template <bool UPPER, class Get>
__device__ long long bound(Get get, long long n, uint32_t v) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    const uint32_t x = get(mid);
    if (UPPER ? x <= v : x < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Shared-memory arrays that threads read at a stride (consecutive elements
// a thread) skip a word every 32, so such reads hit distinct banks.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }
__host__ __device__ constexpr int padded(int n) { return n + (n >> 5) + 1; }

struct SmemGet {                 // a padded shared-memory array
  const uint32_t* a;
  __device__ uint32_t operator()(long long i) const { return a[pad(int(i))]; }
};
struct OldGet {
  const uint32_t* o;
  __device__ uint32_t operator()(long long i) const { return o[i]; }
};
struct BGet {
  BStream b;
  __device__ uint32_t operator()(long long i) const { return b.fp(i); }
};

// Status word of a decoupled look-back: flag (1: the tile's own value, 2:
// the prefix through it) << 32 | value
__device__ __forceinline__ void publish(unsigned long long* st, long long t,
                                        unsigned long long flag, uint32_t v) {
  __threadfence();
  atomicExch(st + t, (flag << 32) | v);
}

// The exclusive prefix of tile t (one thread): the combine of the tiles
// before it, read back to the first that holds its prefix
template <class F>
__device__ uint32_t look_back(unsigned long long* st, long long t, uint32_t id,
                              F f) {
  uint32_t acc = id;
  for (long long i = t - 1; i >= 0; --i) {
    unsigned long long s;
    do {
      s = *((volatile unsigned long long*)(st + i));
    } while ((s >> 32) == 0);
    acc = f(uint32_t(s), acc);
    if ((s >> 32) == 2) break;
  }
  return acc;
}

struct AddU {
  __device__ uint32_t operator()(uint32_t a, uint32_t b) const {
    return a + b;
  }
};
struct MaxI {
  __device__ uint32_t operator()(uint32_t a, uint32_t b) const {
    return int(a) < int(b) ? b : a;
  }
};

__device__ __forceinline__ unsigned long long candidate(long long k,
                                                        uint32_t fp,
                                                        int r_bits,
                                                        long long n_slots) {
  const long long q = fp >> r_bits;
  if (q < 1) return ~0ull;
  return ((unsigned long long)(k - q + n_slots) << 32) |
         (unsigned long long)(q - 1);
}

// Per merge tile (one thread each, all in parallel): its merge-path splits
// and, for a remove, the bounds over the whole streams of its first and last
// group (the fingerprints that may reach past it).
struct MergeTile {
  uint32_t i0, i1;                 // old elements before the tile's ends
  uint32_t lbo, lbb, ubo, ubb;     // first group's lower, last's upper
};

__global__ void __launch_bounds__(kThreads)
    qf_merge_tiles(const uint32_t* __restrict__ o,
                   const unsigned long long* __restrict__ m0p, BStream b,
                   const unsigned long long* __restrict__ nbp, int tm,
                   long long merge_tiles, int remove,
                   MergeTile* __restrict__ info) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long m0 = (long long)*m0p, nb = (long long)*nbp;
  const long long len = m0 + nb, d0 = t * tm;
  if (t >= merge_tiles || d0 >= len) return;
  const long long d1 = d0 + tm < len ? d0 + tm : len;
  MergeTile x{};
  const long long i0 = merge_split(o, m0, b, nb, d0);
  const long long i1 = merge_split(o, m0, b, nb, d1);
  x.i0 = uint32_t(i0);
  x.i1 = uint32_t(i1);
  if (remove) {
    const long long j0 = d0 - i0, j1 = d1 - i1;
    uint32_t f_first = kNone, f_last = 0;
    if (i1 > i0) f_first = o[i0], f_last = o[i1 - 1];
    if (j1 > j0) {
      f_first = b.fp(j0) < f_first ? b.fp(j0) : f_first;
      f_last = b.fp(j1 - 1) > f_last ? b.fp(j1 - 1) : f_last;
    }
    x.lbo = uint32_t(bound<false>(OldGet{o}, m0, f_first));
    x.lbb = uint32_t(bound<false>(BGet{b}, nb, f_first));
    x.ubo = uint32_t(bound<true>(OldGet{o}, m0, f_last));
    x.ubb = uint32_t(bound<true>(BGet{b}, nb, f_last));
  }
  info[t] = x;
}

// This thread's share [d, dend) of a tile's merged order (the old segment
// first on equal fingerprints) and the old and batch elements before d.
__device__ __forceinline__ void thread_share(const uint32_t* so, int n_o,
                                             const uint32_t* sb, int n_b,
                                             int& d, int& dend, int& ia,
                                             int& ib) {
  const int n_t = n_o + n_b;
  const int per = (n_t + blockDim.x - 1) / blockDim.x;
  d = int(threadIdx.x) * per < n_t ? int(threadIdx.x) * per : n_t;
  dend = d + per < n_t ? d + per : n_t;
  ia = d - n_b > 0 ? d - n_b : 0;
  int hi = d < n_o ? d : n_o;
  while (ia < hi) {
    const int mid = (ia + hi) >> 1;
    if (sb[pad(d - 1 - mid)] < so[pad(mid)]) hi = mid; else ia = mid + 1;
  }
  ib = d - ia;
}

// The first index at or before x of a run of f ending just before x + 1 in
// a padded shared array (a short walk; a long run is searched)
__device__ __forceinline__ int run_start(const uint32_t* a, int x,
                                         uint32_t f) {
  for (int step = 0; step < 32; ++step) {
    if (x == 0 || a[pad(x - 1)] != f) return x;
    --x;
  }
  return int(bound<false>(SmemGet{a}, x, f));
}

// One past the last index of the run of f that starts at x (x < n or x = n)
__device__ __forceinline__ int run_end(const uint32_t* a, int n, int x,
                                       uint32_t f) {
  for (int step = 0; step < 32; ++step) {
    if (x == n || a[pad(x)] != f) return x;
    ++x;
  }
  return int(bound<true>(SmemGet{a}, n, f));
}

// 8. Merge tiles of tm elements: the new stream (sorted) and the anchor.
// An add merges a tile in shared memory, each thread its share of the
// outputs from its own merge-path split, then stores the tile coalesced. A
// remove places each element by searches (a group of equal fingerprints is
// usually one element: one search an element) and compacts the kept ones.
template <int OP>
__global__ void __launch_bounds__(kMergeThreads)
    qf_merge(const uint32_t* __restrict__ o,
             const unsigned long long* __restrict__ m0p, BStream b,
             const unsigned long long* __restrict__ nbp,
             uint32_t* __restrict__ ns, long long cap,
             bool* __restrict__ flags, unsigned long long* st,
             unsigned long long* scal, const MergeTile* __restrict__ info,
             int tm, int r_bits, long long n_slots) {
  extern __shared__ uint32_t sm[];
  uint32_t* so = sm;                        // old segment
  uint32_t* sb = so + padded(tm);           // batch segment (fp)
  uint32_t* sout = sb + padded(tm);         // the merged tile (add)
  uint8_t* keep = reinterpret_cast<uint8_t*>(sout + padded(tm));
  __shared__ long long s_t;
  __shared__ uint32_t s_excl;
  const long long m0 = (long long)*m0p, nb = (long long)*nbp;
  const long long len = m0 + nb;
  if (OP == 0 && blockIdx.x == 0 && threadIdx.x == 0)
    scal[kM1] = (unsigned long long)(len < cap ? len : cap);
  if (threadIdx.x == 0)
    s_t = OP == 0 ? (long long)blockIdx.x
                  : (long long)atomicAdd(scal + kMergeTicket, 1ull);
  __syncthreads();
  const long long t = s_t, d0 = t * tm;
  if (d0 >= len) return;
  const long long d1 = d0 + tm < len ? d0 + tm : len;
  const MergeTile x = info[t];
  const long long i0 = x.i0, j0 = d0 - i0;
  const int n_o = int(x.i1 - x.i0), n_b = int((d1 - x.i1) - j0);
  for (int a = threadIdx.x; a < n_o; a += blockDim.x) so[pad(a)] = o[i0 + a];
  for (int a = threadIdx.x; a < n_b; a += blockDim.x)
    sb[pad(a)] = b.fp(j0 + a);
  __syncthreads();
  unsigned long long best = ~0ull;
  if (OP == 0) {
    const int n_t = n_o + n_b;
    int d, dend, ia, ib;
    thread_share(so, n_o, sb, n_b, d, dend, ia, ib);
    for (int k = d; k < dend; ++k)
      sout[pad(k)] = (ib >= n_b || (ia < n_o && so[pad(ia)] <= sb[pad(ib)]))
                         ? so[pad(ia++)]
                         : sb[pad(ib++)];
    __syncthreads();
    for (int a = threadIdx.x; a < n_t; a += blockDim.x) {
      const long long k = d0 + a;
      if (k < cap) ns[k] = sout[pad(a)];
      const unsigned long long c =
          candidate(k, sout[pad(a)], r_bits, n_slots);
      best = c < best ? c : best;
    }
  } else {
    // the tile's first and last group may reach past it: their bounds over
    // the whole streams
    uint32_t f_first = kNone, f_last = 0;
    if (n_o) f_first = so[pad(0)], f_last = so[pad(n_o - 1)];
    if (n_b) {
      f_first = sb[pad(0)] < f_first ? sb[pad(0)] : f_first;
      f_last = sb[pad(n_b - 1)] > f_last ? sb[pad(n_b - 1)] : f_last;
    }
    const long long g_lbo = x.lbo, g_lbb = x.lbb, g_ubo = x.ubo,
                    g_ubb = x.ubb;
    // walk this thread's share of the merged order: when an old copy comes
    // out, ib batch elements (those below it) came before it; when a
    // request comes out, ia old ones (those at or below it). Other bounds
    // of a group inside the tile are short walks over equal neighbours.
    int d, dend, ia, ib;
    thread_share(so, n_o, sb, n_b, d, dend, ia, ib);
    for (int k = d; k < dend; ++k) {
      if (ib >= n_b || (ia < n_o && so[pad(ia)] <= sb[pad(ib)])) {
        // an old copy: removed while its rank is below the requests
        const uint32_t f = so[pad(ia)];
        const long long lbo = f == f_first ? g_lbo
                                           : i0 + run_start(so, ia, f);
        const long long lbb = f == f_first ? g_lbb : j0 + ib;
        const long long ubb = f == f_last ? g_ubb
                                          : j0 + run_end(sb, n_b, ib, f);
        keep[ia] = (i0 + ia - lbo) >= (ubb - lbb);
        ++ia;
      } else {
        // a request: found while its rank (batch order) is below the
        // stored copies
        const uint32_t f = sb[pad(ib)];
        const long long lbb = f == f_first ? g_lbb
                                           : j0 + run_start(sb, ib, f);
        const long long lbo = f == f_first ? g_lbo
                                           : i0 + run_start(so, ia, f);
        const long long ubo = f == f_last ? g_ubo : i0 + ia;
        flags[b.index(j0 + ib)] = (j0 + ib - lbb) < (ubo - lbo);
        ++ib;
      }
    }
    __syncthreads();
    // each thread its consecutive old elements: one block scan to compact
    const int per = (n_o + blockDim.x - 1) / blockDim.x;
    const int a0 = int(threadIdx.x) * per < n_o ? int(threadIdx.x) * per
                                                : n_o;
    const int a1 = a0 + per < n_o ? a0 + per : n_o;
    unsigned long long kept = 0;
    for (int a = a0; a < a1; ++a) kept += keep[a];
    unsigned long long total;
    const unsigned long long before = block_excl(kept, 0ull, AddF{}, &total);
    if (threadIdx.x == 0) {
      uint32_t excl = 0;
      if (t == 0) {
        publish(st, t, 2, uint32_t(total));
      } else {
        publish(st, t, 1, uint32_t(total));
        excl = look_back(st, t, 0u, AddU{});
        publish(st, t, 2, excl + uint32_t(total));
      }
      s_excl = excl;
      if (d1 == len) scal[kM1] = excl + total;
    }
    __syncthreads();
    long long k = (long long)s_excl + (long long)before;
    for (int a = a0; a < a1; ++a) {
      if (keep[a]) {
        if (k < cap) ns[k] = so[pad(a)];
        const unsigned long long cd =
            candidate(k, so[pad(a)], r_bits, n_slots);
        best = cd < best ? cd : best;
        ++k;
      }
    }
  }
  best = block_all(best, ~0ull, MinF{});
  if (threadIdx.x == 0 && best != ~0ull) atomicMin(scal + kAnchor, best);
}

// (A, sA): the anchor and the new index of the first element homed past it
__device__ __forceinline__ void anchor_of(const unsigned long long* scal,
                                          long long m1, long long n_slots,
                                          uint32_t& a, long long& s_a) {
  unsigned long long key =
      ((unsigned long long)m1 << 32) | (unsigned long long)(n_slots - 1);
  const unsigned long long c = scal[kAnchor];
  key = c < key ? c : key;
  a = uint32_t(key & 0xFFFFFFFF);
  s_a = (long long)(key >> 32) - n_slots + a + 1;
  if (s_a >= m1) s_a = 0;
}

// F[w] = j for every table tile w whose rotated start lies in (lo, hi]
// (rotated starts c + k ts, c = (-A - 1) mod ts, ts = 2^lts)
__device__ __forceinline__ void mark(uint32_t* f, long long lo, long long hi,
                                     long long j, uint32_t a, long long c,
                                     int lts, long long nt, uint32_t mask) {
  long long k = lo < c ? 0 : ((lo - c) >> lts) + 1;
  for (; k < nt && c + (k << lts) <= hi; ++k)
    f[((uint32_t(c + (k << lts)) + a + 1u) & mask) >> lts] = uint32_t(j);
}

// 9. Positions in rotated order: a max-plus scan by decoupled look-back.
// The tile's homes and positions pass through shared memory, so the
// device-memory loads and stores are coalesced while each thread scans
// its consecutive elements.
__global__ void __launch_bounds__(kPosThreads)
    qf_positions(const uint32_t* __restrict__ ns,
                 unsigned long long* scal, unsigned long long* st,
                 uint32_t* __restrict__ pos, uint32_t* __restrict__ fpos,
                 uint32_t* __restrict__ fhome, int tm, int r_bits,
                 uint32_t mask, int ts, long long nt) {
  extern __shared__ uint32_t sp[];          // the tile's homes, then slots
  __shared__ long long s_t;
  __shared__ int s_excl;
  const long long n_slots = (long long)mask + 1;
  const long long m1 = (long long)scal[kM1];
  if (threadIdx.x == 0) s_t = (long long)atomicAdd(scal + kPosTicket, 1ull);
  __syncthreads();
  const long long t = s_t, j0 = t * tm;
  if (j0 >= m1) return;
  uint32_t a;
  long long s_a;
  anchor_of(scal, m1, n_slots, a, s_a);
  const int lts = __ffs(ts) - 1;
  const long long c = (-(long long)a - 1) & (ts - 1);
  const int n_t = int(j0 + tm < m1 ? tm : m1 - j0);
  auto home = [&](long long j) {
    long long k = j + s_a;
    if (k >= m1) k -= m1;
    return (int)(((ns[k] >> r_bits) - a - 1u) & mask);
  };
  for (int i = threadIdx.x; i < n_t; i += blockDim.x) sp[pad(i)] = home(j0 + i);
  __syncthreads();
  const int items = (tm + kPosThreads - 1) / kPosThreads;
  const int l0 = threadIdx.x * items;
  int u[kMaxItems];
  int run = kNeg;
#pragma unroll
  for (int k = 0; k < kMaxItems; ++k) {
    if (k < items && l0 + k < n_t) {
      u[k] = int(sp[pad(l0 + k)]);
      const int v = u[k] - int(j0 + l0 + k);
      run = v > run ? v : run;
    }
  }
  long long u_prev = -1;
  if (l0 < n_t && j0 + l0 > 0)
    u_prev = l0 > 0 ? int(sp[pad(l0 - 1)]) : home(j0 - 1);
  int agg;
  const int th_excl = block_excl(run, kNeg, MaxF{}, &agg);
  if (threadIdx.x == 0) {
    int excl = kNeg;
    if (t == 0) {
      publish(st, t, 2, uint32_t(agg));
    } else {
      publish(st, t, 1, uint32_t(agg));
      excl = int(look_back(st, t, uint32_t(kNeg), MaxI{}));
      publish(st, t, 2, uint32_t(excl > agg ? excl : agg));
    }
    s_excl = excl;
  }
  __syncthreads();
  int m = s_excl > th_excl ? s_excl : th_excl;   // max of v before l0
#pragma unroll
  for (int k = 0; k < kMaxItems; ++k) {
    if (k < items && l0 + k < n_t) {
      const long long j = j0 + l0 + k;
      const long long p_prev = j == 0 ? -1 : j - 1 + m;
      const int v = u[k] - int(j);
      m = v > m ? v : m;
      const long long p = j + m;
      const bool cont = j > 0 && u_prev == u[k];
      sp[pad(l0 + k)] = uint32_t(p) | (uint32_t(cont) << 30) |
                   (uint32_t(p != u[k]) << 31);
      mark(fpos, p_prev, p, j, a, c, lts, nt, mask);
      mark(fhome, u_prev, u[k], j, a, c, lts, nt, mask);
      u_prev = u[k];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_t; i += blockDim.x) pos[j0 + i] = sp[pad(i)];
}

// 10. Each table tile's words from its element ranges, stored once
template <int SB>
__global__ void __launch_bounds__(kTileThreads)
    qf_write(uint32_t* __restrict__ table, uint32_t mask, int r_bits, int ts,
             long long nt, const uint32_t* __restrict__ ns,
             const uint32_t* __restrict__ pos,
             const uint32_t* __restrict__ fpos,
             const uint32_t* __restrict__ fhome,
             const unsigned long long* __restrict__ scal) {
  using L = Lanes<SB>;
  extern __shared__ uint32_t words[];
  const long long n_slots = (long long)mask + 1;
  const long long m1 = (long long)scal[kM1];
  const long long w = blockIdx.x, first = w * ts;
  const int n_words = ts / L::SPW;
  for (int i = threadIdx.x; i < n_words; i += blockDim.x) words[i] = 0;
  __syncthreads();
  if (m1 > 0) {
    uint32_t a;
    long long s_a;
    anchor_of(scal, m1, n_slots, a, s_a);
    const long long x = pmod(first - a - 1, n_slots);
    const bool wraps = x + ts > n_slots;
    const uint32_t rm = (1u << r_bits) - 1u;
    auto fp_at = [&](long long j) {
      long long k = j + s_a;
      if (k >= m1) k -= m1;
      return ns[k];
    };
    for (int which = 0; which < 2; ++which) {
      const uint32_t* f = which == 0 ? fpos : fhome;
      const long long f0 = f[w] == kNone ? m1 : f[w];
      const uint32_t nx = f[(w + 1) % nt];
      const long long f1 = nx == kNone ? m1 : nx;
      long long lo[2] = {f0, 0}, hi[2] = {m1, 0};
      if (wraps) hi[1] = f1;
      else if (x + ts < n_slots) hi[0] = f1;
      for (int part = 0; part < 2; ++part) {
        for (long long j = lo[part] + threadIdx.x; j < hi[part];
             j += blockDim.x) {
          const uint32_t fp = fp_at(j);
          long long local;
          uint32_t lane;
          if (which == 0) {
            const uint32_t pm = pos[j];
            local = (long long)(((pm & kPosMask) + a + 1u) & mask) - first;
            lane = (fp & rm) | ((pm >> 30) & 1u ? L::kCont : 0u) |
                   (pm >> 31 ? L::kShift : 0u);
          } else {
            local = (long long)(fp >> r_bits) - first;
            lane = L::kOcc;
          }
          if (local >= 0 && local < ts)
            atomicOr(words + local / L::SPW,
                     lane << (SB * (int(local) % L::SPW)));
        }
      }
    }
  }
  __syncthreads();
  uint32_t* out = table + first / L::SPW;
  for (int i = threadIdx.x; i < n_words; i += blockDim.x) out[i] = words[i];
}

// ---------------------------------------------------------------------------
// The update's workspace (quotientfilter.update_plan carves the same)
// ---------------------------------------------------------------------------

enum Kind : int { kAdd = 0, kRemove = 1, kMerge = 2, kResize = 3 };

// ---------------------------------------------------------------------------
// The binned contains
// ---------------------------------------------------------------------------

constexpr int kBinTestThreads = 512;

// A key's bin (its quotient's top bits) and payload (its fingerprint)
struct QfBinner {
  Geometry g;
  int bin_shift;           // r_bits + log2 quotients a bin
  __device__ __forceinline__ uint32_t operator()(uint2 key,
                                                 uint32_t& payload) const {
    payload = fingerprint(key, g);
    return payload >> bin_shift;
  }
};

// The table's load, for the contains' path rule on the host
// (quotientfilter.choose_contains_path): the slots in use of kSampleRuns
// runs of `run` slots spread over the table, one CTA a run, added into
// out[0] (zeroed before); out[1] gets the slots sampled.
constexpr int kSampleRuns = 128;         // sampled runs of slots
constexpr int kSampleSlots = 2048;       // slots a run, at most

template <int SB>
__global__ void __launch_bounds__(kTileThreads)
    qf_load_sample(const uint32_t* __restrict__ t, uint32_t mask, int run,
                   unsigned long long* __restrict__ out) {
  using L = Lanes<SB>;
  const unsigned long long stride =
      ((unsigned long long)mask + 1) / gridDim.x;
  const unsigned long long base = blockIdx.x * stride;
  unsigned long long used = 0;
  for (int s = threadIdx.x; s < run; s += blockDim.x)
    used += (L::get(t, uint32_t(base + s)) & L::kMeta) != 0;
  used = block_all(used, 0ull, AddF{});
  if (threadIdx.x == 0) {
    atomicAdd(out, used);
    if (blockIdx.x == 0) out[1] = (unsigned long long)run * gridDim.x;
  }
}

// One CTA a bin of 2^lg_bin quotients [q0, q0 + B): the words [w0, w0 +
// window_words) of the table (w0 the 4-word boundary at or before q0's
// word, indices mod n_words) staged in shared memory; the scan from q0
// (occupied bits of the bin's homes, the start of each of its runs); then
// each slot of [starts[j], ends[j]) tested. Dynamic shared memory: the
// window, the occupied bits by slot of the window and their prefix
// (ceil(B / 32) + 1 u32 each) and the runs' starts (B u32).
template <int SB>
__global__ void __launch_bounds__(kBinTestThreads)
    qf_contains_bin(const uint32_t* __restrict__ t, Geometry g, int lg_bin,
                    int ts, const uint32_t* __restrict__ oex,
                    const uint32_t* __restrict__ rex,
                    const unsigned long long* __restrict__ scal,
                    const uint64_t* __restrict__ slots,
                    const uint32_t* __restrict__ starts,
                    const uint32_t* __restrict__ ends,
                    bool* __restrict__ out, int window_words) {
  using L = Lanes<SB>;
  extern __shared__ uint4 smem4[];
  __shared__ uint32_t warp_runs[kBinTestThreads / 32];
  __shared__ uint32_t warp_occ[kBinTestThreads / 32];
  const uint32_t begin = starts[blockIdx.x], end = ends[blockIdx.x];
  if (begin == end) return;                 // no keys: not read
  const long long d = (long long)scal[kD];
  if (d == 0) {                             // an empty table holds nothing
    for (uint32_t k = begin + threadIdx.x; k < end; k += blockDim.x) {
      const uint64_t v = slots[k];
      if (v != kFill8) out[uint32_t(v)] = false;
    }
    return;
  }
  const uint32_t B = 1u << lg_bin;
  const uint32_t q0 = uint32_t(blockIdx.x) << lg_bin;
  const uint32_t n_words = (g.mask + 1u) / L::SPW;
  const uint32_t w0 = (q0 / L::SPW) & ~3u;
  const uint32_t ws = w0 * L::SPW;                   // the window's first slot
  const uint32_t hs = q0 - ws;                       // the bin's, in it
  const uint32_t win_slots = uint32_t(window_words) * L::SPW;
  const int nw = int((hs + B + 31u) / 32u);          // occupied-bit words
  uint32_t* win = reinterpret_cast<uint32_t*>(smem4);
  uint32_t* occ_bits = win + window_words;
  uint32_t* occ_pref = occ_bits + nw;
  uint32_t* run_start = occ_pref + nw;
  const uint64_t policy = evict_first_policy();
  for (int j = 4 * threadIdx.x; j < window_words; j += 4 * blockDim.x)
    bin_copy_async16(win + j, t + ((w0 + uint32_t(j)) & (n_words - 1u)),
                     policy);
  // the bin is whole tiles: its homes' first occupied rank and the run
  // starts before it, read off the tiles' exclusive counts
  const long long k0 = oex[q0 / uint32_t(ts)], r0 = rex[q0 / uint32_t(ts)];
  const long long skip = pmod(k0 + (long long)scal[kW] - r0, d);
  bin_copy_wait_all();
  __syncthreads();
  auto lane_at = [&](uint32_t s) -> uint32_t {
    const uint32_t o = (s - ws) & g.mask;
    if (o < win_slots) {
      if (L::SPW == 1) return win[o];
      return (win[o / L::SPW] >> (SB * (o % L::SPW))) & L::kLane;
    }
    return L::get(t, s);                     // past the window
  };
  // the scan, a word (SPW slots) a thread and blockDim words a step, from
  // the window's first slot: occupied bits of the bin's homes by slot in
  // the window (G = 32 / SPW threads make a 32-bit word), run starts from
  // q0 on ranked by a warp scan and the warps' counts
  constexpr int G = 32 / L::SPW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const long long limit = (2ll * ((long long)g.mask + 1) + hs + B) / L::SPW;
  long long found = 0, nocc = 0;
  for (long long c0 = 0; c0 < limit; c0 += blockDim.x) {
    if (c0 * L::SPW >= hs + B && found >= skip + nocc) break;   // uniform
    const long long wi = c0 + threadIdx.x;
    const uint32_t word = wi < window_words
                              ? win[wi]
                              : __ldg(t + ((w0 + uint32_t(wi)) &
                                           (n_words - 1u)));
    uint32_t occ_n = 0u, rs_n = 0u;
#pragma unroll
    for (int j = 0; j < L::SPW; ++j) {
      const uint32_t l = (word >> (SB * j)) & L::kLane;
      const long long off = wi * L::SPW + j;             // slot in the window
      if (off >= hs && off < hs + B && (l & L::kOcc)) occ_n |= 1u << j;
      if (off >= hs && (l & L::kMeta) && !(l & L::kCont)) rs_n |= 1u << j;
    }
    uint32_t ob = occ_n << ((lane % G) * L::SPW);
#pragma unroll
    for (int dd = 1; dd < G; dd <<= 1) ob |= __shfl_xor_sync(0xFFFFFFFFu, ob, dd);
    const long long ow = (wi * L::SPW) >> 5;
    if (lane % G == 0 && ow < nw) occ_bits[ow] = ob;
    const uint32_t cnt = __popc(rs_n);
    uint32_t incl = cnt;
#pragma unroll
    for (int dd = 1; dd < 32; dd <<= 1) {
      const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, incl, dd);
      if (lane >= dd) incl += y;
    }
    const uint32_t occs_w = __reduce_add_sync(0xFFFFFFFFu, __popc(occ_n));
    if (lane == 31) warp_runs[warp] = incl;
    if (lane == 0) warp_occ[warp] = occs_w;
    __syncthreads();
    long long before = found + incl - cnt, runs = 0, occs = 0;
    for (int k = 0; k < warps; ++k) {
      const uint32_t v = warp_runs[k];
      before += k < warp ? v : 0u;
      runs += v;
      occs += warp_occ[k];
    }
    for (uint32_t m = rs_n; m != 0u; m &= m - 1u, ++before) {
      const long long j = before - skip;
      if (j >= 0 && j < (long long)B)
        run_start[j] = (ws + uint32_t(wi * L::SPW + __ffs(m) - 1)) & g.mask;
    }
    found += runs;
    nocc += occs;
    __syncthreads();                         // the warps' counts are reused
  }
  for (int k = threadIdx.x; k < nw; k += blockDim.x)
    occ_pref[k] = __popc(occ_bits[k]);
  __syncthreads();
  block_scan_array(occ_pref, nw);
  __syncthreads();
  const uint32_t rm = rem_mask(g);
  // each slot's key: the next slot loads while this one is tested
  uint64_t next = begin + threadIdx.x < end ? __ldcs(slots + begin +
                                                     threadIdx.x)
                                            : kFill8;
  for (uint32_t k = begin + threadIdx.x; k < end; k += blockDim.x) {
    const uint64_t v = next;
    next = k + blockDim.x < end ? __ldcs(slots + k + blockDim.x) : kFill8;
    if (v == kFill8) continue;
    const uint32_t fp = uint32_t(v >> 32), rem = fp & rm;
    const uint32_t i = (fp >> g.r_bits) - q0 + hs;    // its home, in the window
    const uint32_t word = occ_bits[i >> 5], bit = 1u << (i & 31u);
    bool hit = false;
    if (word & bit) {
      uint32_t s = run_start[occ_pref[i >> 5] + __popc(word & (bit - 1u))];
      uint32_t l = lane_at(s);
      while (true) {                         // remainders ascend in a run
        const uint32_t rv = l & rm;
        if (rv >= rem) {
          hit = rv == rem;
          break;
        }
        s = (s + 1u) & g.mask;
        l = lane_at(s);
        if (!(l & L::kCont)) break;
      }
    }
    out[uint32_t(v)] = hit;
  }
}

struct Layout {
  unsigned long long* scal;             // 2 x kScalN
  uint32_t *tu, *tr, *to, *te, *tcf;    // per table tile
  uint32_t *fpos, *fhome;               // nt + 1 each
  uint32_t* chunk_valid;                // kKeyChunks
  uint32_t* hist;                       // kKeyChunks x n_bins
  uint32_t* bin_off;                    // n_bins + 1
  unsigned long long *st_merge, *st_pos;
  MergeTile* tiles;                     // a merge tile's splits and bounds
  uint32_t *oa, *ob, *ns, *pos;         // element streams (pos shares oa)
  unsigned long long* keys;             // the batch's sorted pairs
  long long nt, merge_tiles, pos_tiles, cap, bytes;
};

long long r256(long long b) { return (b + 255) / 256 * 256; }

Layout make_layout(char* base, int kind, long long n_slots, long long n_out,
                   long long nk, int ts, int tm, int bin_bits) {
  Layout l{};
  const bool update = kind == kAdd || kind == kRemove;
  const long long cap = n_slots - 1;
  const long long ts_in = ts < n_slots ? ts : n_slots;
  const long long ts_out = ts < n_out ? ts : n_out;
  l.nt = n_slots / ts_in > n_out / ts_out ? n_slots / ts_in : n_out / ts_out;
  const long long n_bins = update ? 1ll << bin_bits : 0;
  const long long merged =
      cap + (update ? nk : kind == kMerge ? cap : 0);
  l.merge_tiles = merged > tm ? (merged + tm - 1) / tm : 1;
  l.pos_tiles = cap > tm ? (cap + tm - 1) / tm : 1;
  l.cap = cap;
  long long at = 0;
  auto take = [&](long long bytes) {
    char* p = base == nullptr ? nullptr : base + at;
    at += r256(bytes);
    return p;
  };
  l.scal = reinterpret_cast<unsigned long long*>(take(512));
  uint32_t** tiles[5] = {&l.tu, &l.tr, &l.to, &l.te, &l.tcf};
  for (auto p : tiles) *p = reinterpret_cast<uint32_t*>(take(4 * l.nt));
  l.fpos = reinterpret_cast<uint32_t*>(take(4 * (l.nt + 1)));
  l.fhome = reinterpret_cast<uint32_t*>(take(4 * (l.nt + 1)));
  l.chunk_valid = reinterpret_cast<uint32_t*>(take(4 * kKeyChunks * update));
  l.hist = reinterpret_cast<uint32_t*>(take(4 * kKeyChunks * n_bins));
  l.bin_off = reinterpret_cast<uint32_t*>(take(4 * (n_bins + 1) * update));
  l.st_merge = reinterpret_cast<unsigned long long*>(take(8 * l.merge_tiles));
  l.st_pos = reinterpret_cast<unsigned long long*>(take(8 * l.pos_tiles));
  l.tiles = reinterpret_cast<MergeTile*>(
      take(sizeof(MergeTile) * l.merge_tiles));
  l.oa = reinterpret_cast<uint32_t*>(take(4 * cap));
  l.ob = reinterpret_cast<uint32_t*>(take(4 * cap * (kind == kMerge)));
  l.ns = reinterpret_cast<uint32_t*>(take(4 * cap));
  l.keys = reinterpret_cast<unsigned long long*>(take(8 * nk));
  l.pos = l.oa;                       // the old streams are read by then
  l.bytes = at;
  return l;
}

bool bad_knobs(int ts, int tm) {
  return ts < 32 || ts > kMaxTile || (ts & (ts - 1)) || tm < 1 ||
         tm > kMaxTile;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 1;
  return sms > 0 ? sms : 1;
}

// stages 1-3 of one table into `out`; scal: its scalars
template <int SB>
int launch_decode(const uint32_t* table, const Geometry& g, int ts,
                  const Layout& l, unsigned long long* scal, bool init,
                  uint32_t* out, const uint8_t* valid, long long n,
                  int chunks, long long nt_out, cudaStream_t st) {
  const long long n_slots = (long long)g.mask + 1;
  const int tsi = ts < n_slots ? ts : int(n_slots);
  const long long nt = n_slots / tsi;
  const int vchunks = valid != nullptr ? chunks : 0;
  qf_tile_stats<SB><<<unsigned(nt + vchunks), kTileThreads, 0, st>>>(
      table, g.mask, tsi, nt, l.tu, l.tr, l.to, l.te, l.tcf, valid, n,
      chunks, l.chunk_valid);
  qf_scan_tables<SB><<<1, kTileThreads, 0, st>>>(
      table, g.mask, tsi, nt, l.tu, l.tr, l.to, l.te, scal,
      vchunks ? l.chunk_valid : nullptr, chunks, init, l.scal, l.st_merge,
      l.merge_tiles, l.st_pos, l.pos_tiles, l.fpos, l.fhome, nt_out);
  qf_decode<SB><<<unsigned(nt), kTileThreads, (tsi + 1) * 4, st>>>(
      table, g.mask, g.r_bits, tsi, nt, l.tu, l.tr, l.to, l.tcf, scal, out,
      l.cap);
  QF_CHECK();
  return 0;
}

// stages 8-10 into `table` (geometry g)
template <int SB, int OP>
int launch_rebuild(uint32_t* table, const Geometry& g, int ts, int tm,
                   const Layout& l, const unsigned long long* m0p, BStream b,
                   const unsigned long long* nbp, bool* flags,
                   cudaStream_t st) {
  const long long n_slots = (long long)g.mask + 1;
  const int tso = ts < n_slots ? ts : int(n_slots);
  const long long nt = n_slots / tso;
  const int merge_smem = 12 * padded(tm) + tm;
  cudaError_t err = cudaFuncSetAttribute(
      qf_merge<OP>, cudaFuncAttributeMaxDynamicSharedMemorySize, merge_smem);
  if (err != cudaSuccess) return int(err);
  qf_merge_tiles<<<unsigned((l.merge_tiles + kThreads - 1) / kThreads),
                   kThreads, 0, st>>>(l.oa, m0p, b, nbp, tm, l.merge_tiles,
                                      OP == kRemove, l.tiles);
  qf_merge<OP><<<unsigned(l.merge_tiles), kMergeThreads, merge_smem, st>>>(
      l.oa, m0p, b, nbp, l.ns, l.cap, flags, l.st_merge, l.scal, l.tiles, tm,
      g.r_bits, n_slots);
  qf_positions<<<unsigned(l.pos_tiles), kPosThreads, 4 * padded(tm), st>>>(
      l.ns, l.scal, l.st_pos, l.pos, l.fpos, l.fhome, tm, g.r_bits, g.mask,
      tso, nt);
  qf_write<SB><<<unsigned(nt), kTileThreads, tso / (32 / SB) * 4, st>>>(
      table, g.mask, g.r_bits, tso, nt, l.ns, l.pos, l.fpos, l.fhome,
      l.scal);
  QF_CHECK();
  return 0;
}

template <int SB, int OP>
int launch_update(const uint2* keys, const uint8_t* valid, uint32_t* table,
                  bool* flags, long long n, const Geometry& g, char* work,
                  long long work_bytes, int ts, int tm, int bin_bits,
                  int bin_cap, int key_chunks, cudaStream_t st) {
  const long long n_slots = (long long)g.mask + 1;
  const Layout l =
      make_layout(work, OP, n_slots, n_slots, n, ts, tm, bin_bits);
  if (l.bytes > work_bytes) return -1;
  const long long want = (n + 1023) / 1024;
  int chunks = key_chunks > 0 ? key_chunks : sm_count();
  chunks = chunks < kKeyChunks ? chunks : kKeyChunks;
  chunks = want < chunks ? int(want) : chunks;
  const int n_bins = 1 << bin_bits, shift = g.p_bits - bin_bits;
  int err = launch_decode<SB>(table, g, ts, l, l.scal, true, l.oa, valid, n,
                              chunks, l.nt, st);
  if (err) return err;
  qf_bin_count<OP><<<chunks, kKeyThreads, n_bins * 4, st>>>(
      keys, valid, n, chunks, l.chunk_valid, l.scal, flags, l.hist, n_bins,
      shift, g);
  qf_bin_offsets<<<1, kKeyThreads, 0, st>>>(l.hist, chunks, n_bins,
                                            l.bin_off, l.scal);
  using K = SortKey<OP>;
  K* const sorted = reinterpret_cast<K*>(l.keys);
  qf_bin_scatter<OP><<<chunks, kKeyThreads, n_bins * 4, st>>>(
      keys, valid, n, chunks, l.chunk_valid, l.scal, l.hist, n_bins, shift,
      g, sorted);
  const int sort_smem = sort_smem_bytes(bin_cap, sizeof(K));
  const cudaError_t e = cudaFuncSetAttribute(
      qf_bin_sort<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      sort_smem);
  if (e != cudaSuccess) return int(e);
  qf_bin_sort<K><<<n_bins, kKeyThreads, sort_smem, st>>>(
      sorted, l.bin_off, bin_cap, g.p_bits - bin_bits);
  QF_CHECK();
  return launch_rebuild<SB, OP>(
      table, g, ts, tm, l, l.scal + kM0,
      BStream{reinterpret_cast<const uint32_t*>(l.keys), int(sizeof(K) / 4)},
      l.scal + kNb, flags, st);
}

// The binned contains' workspace (quotientfilter.contains_plan carves the
// same, 256-byte aligned): the scalars, the five tile arrays, the chunks'
// counts, the bins' starts and ends, and a batch's slots (each chunk's run
// in a bin padded to 4 slots).
struct ContainsLayout {
  unsigned long long* scal;
  uint32_t *tu, *tr, *to, *te, *tcf;
  uint32_t *counts, *starts, *ends;
  uint64_t* slots;
  long long bytes;
};

ContainsLayout make_contains_layout(char* base, long long nt, int n_bins,
                                    int chunks, long long batch) {
  ContainsLayout l{};
  long long at = 0;
  auto take = [&](long long bytes) {
    char* p = base == nullptr ? nullptr : base + at;
    at += r256(bytes);
    return p;
  };
  l.scal = reinterpret_cast<unsigned long long*>(take(8 * kScalN));
  uint32_t** tiles[5] = {&l.tu, &l.tr, &l.to, &l.te, &l.tcf};
  for (auto p : tiles) *p = reinterpret_cast<uint32_t*>(take(4 * nt));
  l.counts = reinterpret_cast<uint32_t*>(take(4ll * chunks * n_bins));
  l.starts = reinterpret_cast<uint32_t*>(take(4ll * n_bins));
  l.ends = reinterpret_cast<uint32_t*>(take(4ll * n_bins));
  l.slots = reinterpret_cast<uint64_t*>(
      take(8 * (batch + 3ll * chunks * n_bins)));
  l.bytes = at;
  return l;
}

enum ContainsPath : int { kWalk = 0, kBinned = 1 };

// table tiles of a binned contains: a tile a bin (the tile pass then
// launches a CTA a bin, and its scan takes a count a bin)
int contains_tile_slots(int lg_bin) { return 1 << lg_bin; }

size_t contains_test_smem(int lg_bin, int window_words) {
  const size_t b = size_t(1) << lg_bin;
  return 4 * (size_t(window_words) + 2 * ((b + 31) / 32 + 1) + b);
}

// The cluster walk or the binned contains. The binned path's batches each
// run the four bin stages and the test; the tile pass runs once a call.
template <int SB>
int launch_contains(const uint2* keys, const uint32_t* table, bool* out,
                    int64_t n, const Geometry& g, int path, char* work,
                    long long work_bytes, int lg_bin, int window_words,
                    long long batch, int chunks, cudaStream_t st) {
  if (path == kWalk) {
    quotient_contains_kernel<SB><<<grid_of(n), kThreads, 0, st>>>(
        keys, table, out, n, g);
    return int(cudaGetLastError());
  }
  const long long n_slots = (long long)g.mask + 1;
  const int ts = contains_tile_slots(lg_bin);
  const long long nt = n_slots / ts;
  const int n_bins = int(n_slots >> lg_bin);
  const Bin8Geometry bg = bin8_geometry(n_bins);
  // a batch's slots: at most min(n, batch) keys
  const ContainsLayout l = make_contains_layout(work, nt, n_bins, chunks,
                                                n < batch ? n : batch);
  if (l.bytes > work_bytes) return -1;
  int card_chunks = 0, test_room = 0;
  cudaError_t err = bin8_prepare<QfBinner>(bg, &card_chunks);
  if (err == cudaErrorInvalidValue) return -1;
  // the test kernel's static shared memory (the warps' counts, the block
  // scan's) leaves the rest of the card's limit to its dynamic part
  if (err == cudaSuccess) err = raise_smem(qf_contains_bin<SB>, &test_room);
  if (err != cudaSuccess) return int(err);
  const size_t test_smem = contains_test_smem(lg_bin, window_words);
  if (test_smem > size_t(test_room)) return -1;
  qf_tile_stats<SB><<<unsigned(nt), kTileThreads, 0, st>>>(
      table, g.mask, ts, nt, l.tu, l.tr, l.to, l.te, l.tcf, nullptr, 0, 0,
      nullptr);
  qf_scan_tables<SB><<<1, kTileThreads, 0, st>>>(
      table, g.mask, ts, nt, l.tu, l.tr, l.to, l.te, l.scal, nullptr, 0, 0,
      nullptr, nullptr, 0, nullptr, 0, nullptr, nullptr, 0);
  const QfBinner binner{g, g.r_bits + lg_bin};
  for (long long first = 0; first < n; first += batch) {
    const long long nb = n - first < batch ? n - first : batch;
    bin8_stages(keys + first, nb, bg, chunks, binner, l.counts, l.starts,
                l.ends, l.slots, st);
    qf_contains_bin<SB><<<n_bins, kBinTestThreads, test_smem, st>>>(
        table, g, lg_bin, ts, l.to, l.tr, l.scal, l.slots, l.starts, l.ends,
        out + first, window_words);
    QF_CHECK();
  }
  return int(cudaGetLastError());
}

bool bad_geometry(int lg_slots, int r_bits, int slot_bits) {
  return lg_slots < 0 || lg_slots > 29 || r_bits < 1 ||
         r_bits > slot_bits - 3 || lg_slots + r_bits > 31;
}

}  // namespace

extern "C" {

// keys: (n, 2) int32 [hi, lo], 8-byte aligned; table: (n_words,) int32,
// 16-byte aligned; out: (n,) bool. lg_slots <= 29, 1 <= r_bits <=
// slot_bits - 3, lg_slots + r_bits <= 31, slot_bits 8, 16 or 32. path 0:
// the cluster walk (no workspace); 1: the binned contains. The binned path
// takes bins of 2^lg_bin quotients (at most 8192 bins, n_words a multiple
// of 4), a test CTA's window of window_words table words (a multiple of 4
// in [4, n_words]), internal batches of at most `batch` keys, `chunks` CTAs
// of the bin stages (quotient_binned_chunks) and work: work_bytes of device
// memory, at least quotientfilter.contains_plan's workspace_bytes.
int quotient_contains(const void* keys, const void* table, void* out,
                      long long n, int lg_slots, int r_bits, int slot_bits,
                      unsigned fp_salt, int path, void* work,
                      long long work_bytes, int lg_bin, int window_words,
                      long long batch, int chunks, void* stream) {
  if (n <= 0) return 0;
  if (bad_geometry(lg_slots, r_bits, slot_bits) || path < kWalk ||
      path > kBinned)
    return -1;
  const long long n_words = (1ll << lg_slots) * slot_bits / 32;
  if (path == kBinned &&
      (lg_bin < 0 || lg_bin > lg_slots || lg_slots - lg_bin > kLog2MaxBins ||
       n_words % 4 != 0 || window_words < 4 || window_words % 4 != 0 ||
       window_words > n_words || batch < 1 || batch > (1ll << 31) ||
       chunks < 1 ||
       batch + 3ll * chunks * (1ll << (lg_slots - lg_bin)) > (1ll << 32) - 1 ||
       work == nullptr))
    return -1;
  const Geometry g{uint32_t((1ull << lg_slots) - 1), r_bits,
                   lg_slots + r_bits, fp_salt};
  const uint2* k = static_cast<const uint2*>(keys);
  const uint32_t* t = static_cast<const uint32_t*>(table);
  bool* o = static_cast<bool*>(out);
  char* w = static_cast<char*>(work);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(SB)                                                          \
  launch_contains<SB>(k, t, o, n, g, path, w, work_bytes, lg_bin,         \
                      window_words, batch, chunks, st)
  switch (slot_bits) {
    case 8:
      return CALL(8);
    case 16:
      return CALL(16);
    case 32:
      return CALL(32);
  }
#undef CALL
  return -1;
}

// table: (n_words,) int32 of 2^lg_slots slots of slot_bits (8, 16 or 32),
// lg_slots <= 29; out: 2 u64 (zeroed before): the slots in use of a sample
// of the table (qf_load_sample) and the slots sampled.
int quotient_load_sample(const void* table, int lg_slots, int slot_bits,
                         void* out, void* stream) {
  if (lg_slots < 0 || lg_slots > 29) return -1;
  const long long n_slots = 1ll << lg_slots;
  const long long blocks = n_slots < kSampleRuns ? n_slots : kSampleRuns;
  const int run = int(n_slots / blocks < kSampleSlots ? n_slots / blocks
                                                      : kSampleSlots);
  const uint32_t* t = static_cast<const uint32_t*>(table);
  const uint32_t mask = uint32_t(n_slots - 1);
  auto* o = static_cast<unsigned long long*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (slot_bits) {
    case 8:
      qf_load_sample<8><<<unsigned(blocks), kTileThreads, 0, st>>>(t, mask,
                                                                   run, o);
      break;
    case 16:
      qf_load_sample<16><<<unsigned(blocks), kTileThreads, 0, st>>>(t, mask,
                                                                    run, o);
      break;
    case 32:
      qf_load_sample<32><<<unsigned(blocks), kTileThreads, 0, st>>>(t, mask,
                                                                    run, o);
      break;
    default:
      return -1;
  }
  return int(cudaGetLastError());
}

// The bin stages' CTAs (chunks) of a binned contains in bins of 2^lg_bin
// quotients of a 2^lg_slots-slot table on the current device, which size
// its workspace; -1 for a geometry without kernels or an error.
int quotient_binned_chunks(int lg_slots, int lg_bin) {
  if (lg_bin < 0 || lg_bin > lg_slots || lg_slots - lg_bin > kLog2MaxBins)
    return -1;
  int chunks = 0;
  if (bin8_prepare<QfBinner>(bin8_geometry(1 << (lg_slots - lg_bin)),
                             &chunks) != cudaSuccess)
    return -1;
  return chunks;
}

// keys: (n, 2) int32 [hi, lo], n <= 2^24; valid: (n,) uint8 or null (every
// key valid); table: (n_words,) int32, rebuilt in place; flags: (n,) bool
// (ok for add, found for remove); op: 0 add, 1 remove. work: work_bytes of
// device memory, at least quotientfilter.update_plan's workspace_bytes
// (the same Layout); tile_slots a power of two in [32, 4096], merge_tile in
// [1, 4096], 0 <= bin_bits <= min(p, 12), 1 <= bin_cap <= 8192, key_chunks
// in [0, 256] (the CTAs of the key stages; 0: one an SM).
int quotient_update(const void* keys, const void* valid, void* table,
                    void* flags, long long n, int lg_slots, int r_bits,
                    int slot_bits, unsigned fp_salt, int op, void* work,
                    long long work_bytes, int tile_slots, int merge_tile,
                    int bin_bits, int bin_cap, int key_chunks,
                    void* stream) {
  if (n <= 0) return 0;
  if (bad_geometry(lg_slots, r_bits, slot_bits) || n > kKeyBatch ||
      (op != kAdd && op != kRemove) || bad_knobs(tile_slots, merge_tile) ||
      bin_bits < 0 || bin_bits > kMaxBinBits ||
      bin_bits > lg_slots + r_bits || bin_cap < 1 || bin_cap > kBinCap ||
      key_chunks < 0 || key_chunks > kKeyChunks)
    return -1;
  const Geometry g{uint32_t((1ull << lg_slots) - 1), r_bits,
                   lg_slots + r_bits, fp_salt};
  const uint2* k = static_cast<const uint2*>(keys);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  uint32_t* t = static_cast<uint32_t*>(table);
  bool* fl = static_cast<bool*>(flags);
  char* w = static_cast<char*>(work);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(SB)                                                            \
  (op == kAdd ? launch_update<SB, kAdd>(k, v, t, fl, n, g, w, work_bytes,   \
                                        tile_slots, merge_tile, bin_bits,   \
                                        bin_cap, key_chunks, st)            \
              : launch_update<SB, kRemove>(k, v, t, fl, n, g, w,            \
                                           work_bytes, tile_slots,          \
                                           merge_tile, bin_bits, bin_cap,   \
                                           key_chunks, st))
  switch (slot_bits) {
    case 8:
      return CALL(8);
    case 16:
      return CALL(16);
    case 32:
      return CALL(32);
  }
#undef CALL
  return -1;
}

// out = the union of tables a and b (same geometry; the caller checks
// count_a + count_b <= n_slots - 1); work as for quotient_update (kind
// merge).
int quotient_merge(const void* table_a, const void* table_b, void* out,
                   int lg_slots, int r_bits, int slot_bits, void* work,
                   long long work_bytes, int tile_slots, int merge_tile,
                   void* stream) {
  if (bad_geometry(lg_slots, r_bits, slot_bits) ||
      bad_knobs(tile_slots, merge_tile))
    return -1;
  const long long n_slots = 1ll << lg_slots;
  const Layout l = make_layout(static_cast<char*>(work), kMerge, n_slots,
                               n_slots, 0, tile_slots, merge_tile, 0);
  if (l.bytes > work_bytes) return -1;
  const Geometry g{uint32_t(n_slots - 1), r_bits, lg_slots + r_bits, 0u};
  const uint32_t* a = static_cast<const uint32_t*>(table_a);
  const uint32_t* b = static_cast<const uint32_t*>(table_b);
  uint32_t* o = static_cast<uint32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* sb = l.scal + kScalN;
#define CALL(SB)                                                             \
  do {                                                                       \
    int e = launch_decode<SB>(a, g, tile_slots, l, l.scal, true, l.oa,       \
                              nullptr, 0, 0, l.nt, st);                      \
    if (!e) e = launch_decode<SB>(b, g, tile_slots, l, sb, false, l.ob,      \
                                  nullptr, 0, 0, l.nt, st);                  \
    if (!e) e = launch_rebuild<SB, kAdd>(o, g, tile_slots, merge_tile, l,    \
                                         l.scal + kM0, BStream{l.ob, 1},     \
                                         sb + kM0, nullptr, st);             \
    return e;                                                                \
  } while (0)
  switch (slot_bits) {
    case 8:
      CALL(8);
    case 16:
      CALL(16);
    case 32:
      CALL(32);
  }
#undef CALL
  return -1;
}

// out (2^new_lg_slots lanes) = table's fingerprints re-split as new_lg_slots
// + new_r_bits (lg_slots + r_bits == new_lg_slots + new_r_bits; the caller
// checks a shrink's capacity); work as for quotient_update (kind resize).
int quotient_resize(const void* table, void* out, int lg_slots, int r_bits,
                    int new_lg_slots, int new_r_bits, int slot_bits,
                    void* work, long long work_bytes, int tile_slots,
                    int merge_tile, void* stream) {
  if (bad_geometry(lg_slots, r_bits, slot_bits) ||
      bad_geometry(new_lg_slots, new_r_bits, slot_bits) ||
      lg_slots + r_bits != new_lg_slots + new_r_bits ||
      bad_knobs(tile_slots, merge_tile))
    return -1;
  const long long n_slots = 1ll << lg_slots, n_out = 1ll << new_lg_slots;
  const Layout l = make_layout(static_cast<char*>(work), kResize, n_slots,
                               n_out, 0, tile_slots, merge_tile, 0);
  if (l.bytes > work_bytes) return -1;
  const Geometry g{uint32_t(n_slots - 1), r_bits, lg_slots + r_bits, 0u};
  const Geometry gn{uint32_t(n_out - 1), new_r_bits, lg_slots + r_bits, 0u};
  const long long tso = tile_slots < n_out ? tile_slots : n_out;
  const uint32_t* t = static_cast<const uint32_t*>(table);
  uint32_t* o = static_cast<uint32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(SB)                                                             \
  do {                                                                       \
    int e = launch_decode<SB>(t, g, tile_slots, l, l.scal, true, l.oa,       \
                              nullptr, 0, 0, n_out / tso, st);               \
    if (!e) e = launch_rebuild<SB, kAdd>(o, gn, tile_slots, merge_tile, l,   \
                                         l.scal + kM0, BStream{nullptr, 1},  \
                                         l.scal + kNb, nullptr, st);         \
    return e;                                                                \
  } while (0)
  switch (slot_bits) {
    case 8:
      CALL(8);
    case 16:
      CALL(16);
    case 32:
      CALL(32);
  }
#undef CALL
  return -1;
}

}  // extern "C"
