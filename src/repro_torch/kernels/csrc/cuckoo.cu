// Cuckoo fingerprint filter kernels for Hopper (sm_90a): bulk contains and
// the ordered bulk insert / remove.
//
// Replaces the Pallas entry points of repro/kernels/cuckoofilter.py:
//   cuckoo_contains_kernel<SB, SPB>    <- contains_vmem (_contains_kernel,
//                          which runs core/fingerprint.py cuckoo_contains or
//                          cuckoo_contains_coop)
//   cuckoo_order_kernel<SB> then       <- add_vmem and remove_vmem
//   cuckoo_apply_kernel<SB, SPB, OP>      (_update_vmem, _update_kernel, which
//                          run cuckoo_insert_tile / cuckoo_remove_tile)
//
// Table. n_buckets buckets of SPB fingerprints of SB (8 or 16) bits, packed
// little-endian into S = SPB * SB / 32 u32 words a bucket: slot j is lane
// j % (32 / SB) of word j / (32 / SB). A slot of 0 is empty.
//
// Hashes (core/fingerprint.py cuckoo_hashes): h1 (pattern stream) and h2
// (block stream) are the shared xxh32 of the key; fp = mulshift(h1,
// SALTS[0], SB), 0 mapped to 1; b1 = h2 & (n_buckets - 1); the alternate
// bucket is b ^ mulshift(fp, SALTS[1], log2 n_buckets) (b itself for one
// bucket); the victim stream starts at h1 ^ SEED_AUX.
//
// * cuckoo_contains_kernel: one thread per key loads its primary bucket
//   (S <= 4: one load of at most 128 bits; S = 8: two) and compares the
//   lanes with fp; it loads the alternate bucket only when the primary one
//   misses. That is the result of both coop values (the alternate test is
//   ORed in, and a primary hit stays a hit), so one kernel serves coop =
//   "none" and "subtile"; skipping the second load per key is what the
//   TPU's tile-wide ballot approximates. Bound: one or two random bucket
//   reads a key, from L2 or DRAM. Measured slower on the H100 and not
//   kept (PERF.md, row 20): both buckets' loads issued at once, with one
//   or two keys a thread (they read the alternate bucket's sector for the
//   two thirds of the keys that hit their primary one), and a binned
//   contains that tests bins of primary buckets in shared memory (it reads
//   the table once an internal batch and a random sector a primary miss).
//
// * The update. The words depend on the order of the inserts (which slot is
//   free, which victim a kick evicts), and the reference order is
//   sequential: tiles of `tile` keys over the unpadded batch, each stably
//   sorted by primary bucket, applied key by key as _insert_one /
//   _remove_one (the first free slot of b1, else of the alternate bucket,
//   else up to 64 kicks, each evicting lane r >> (32 - log2 SPB) of the
//   current bucket and moving the victim to its own alternate bucket, r =
//   r * 747796405 + 2891336453 after each kick; a remove clears the first
//   slot holding fp, primary bucket first; invalid slots are no-ops that
//   report true). A parallel CAS cuckoo gives another table, so the
//   update keeps that order and overlaps only what the order allows:
//
//   1. cuckoo_order_kernel sorts every tile at once, one CTA a chunk of
//      whole tiles (at least 2048 keys, or one tile of up to 8192), by
//      (tile, b1, index) with a bitonic sort in shared memory, and writes
//      the apply order: position p holds (b1, fp or 0 for an invalid key,
//      victim stream, original index). Position p is the key's priority.
//   2. cuckoo_apply_kernel, one persistent CTA (the order is global), takes
//      windows of the next W <= 1024 keys of the order, one a thread, in
//      rounds:
//      - speculate: every key runs its whole chain against the committed
//        table, reading through L2 (ld.global.cg) and through a private
//        overlay in shared memory that logs its own word writes in order,
//        so that its chain sees its own writes. A key may make `step_cap`
//        bucket reads a round (default 66, the longest chain) and
//        min(16384 / W, 72) writes; a key that needs more is capped.
//        Nothing writes the table meanwhile.
//      - key 0 of the window, if capped, finishes alone: its chain so far
//        read only the committed table with no key before it, so it is
//        exact; its thread stores its overlay and runs the rest of its
//        chain on the table directly.
//      - validate: a key's read set R is b1, the alternate bucket when read,
//        the last bucket read and the buckets of its overlay (every other
//        read bucket is written); W (the overlay's buckets) is a subset of
//        R. The keys' W go into a hash set in shared memory keyed by bucket
//        and holding its lowest writer (atomicMin); a key whose overlay
//        would take the window's inserts past kHashBudget ends the window
//        (a prefix sum by position, so the set never fills). The window
//        ends at the first key i whose R meets an earlier key's W
//        (conflict), that is past the budget, or that is capped: a ballot
//        into a 1024-bit map of the keys that end it, and its first bit.
//      - commit: keys before i store their overlays (their write sets are
//        disjoint, so no atomics) and their flags at their original index.
//        Where key i was capped and read no earlier key's write, it is now
//        first and its chain so far exact: after a barrier it finishes
//        alone (its writes entered in the set as position i's), the keys
//        up to the next that ends are checked again, and the window goes
//        on past i; while the set has room (kAloneRoom). Otherwise the
//        next window starts at i.
//      - adapt: the next window halves (down to 256, or `window` where
//        that is smaller) after a round in which a key was capped, so the keys'
//        overlays grow (16 writes at 1024 keys, 64 at 256) and long kick
//        chains run in parallel, not alone; it doubles (up to `window`)
//        after a round that committed the whole window.
//      Exactness by induction along the window: a key before i read only
//      buckets that no earlier key of the window writes, so it saw the
//      sequential state, and its chain, writes and flag are the sequential
//      ones. Key 0 always commits, so a round commits at least one key.
//      W = 1 is the serial order with no speculation.
//   The kernel counts rounds, the rounds that ended on a conflict and on a
//   capped key (past the budget or the set's room), the keys that finished
//   alone, the fewest and most keys a round committed, the sum over rounds
//   of the round's longest speculative chain plus the reads of the chains
//   finished alone (in bucket reads) and all reads, into an int64 (8,)
//   tensor. Bound: the work is one or a few random bucket sectors a key
//   (bytes); this schedule's floor is those longest chains of dependent L2
//   or DRAM round trips, plus 5 or more block barriers a round.
//   Shared memory of the apply CTA: the overlays 16384 x 8 B = 128 KiB,
//   the hash set 8192 x 8 B = 64 KiB, ~1.5 KiB of maps and reductions:
//   193.5 KiB of the 227 KiB a CTA may take.
//
// * chase_kernel: not a port of a TPU kernel but the latency probe behind
//   the update's floor: one thread follows a chain of dependent loads
//   through a buffer, so its time a step is the round trip that each of
//   the update's bucket reads waits for.
//
// C interface for ctypes: each entry point returns cudaGetLastError() after
// its launch (or -1 for a shape that has no instantiation).

#include "bloom_common.cuh"

namespace {

constexpr int kMaxKicks = 64;
constexpr uint32_t kSeedAux = 0x9E3779B9u;
constexpr uint32_t kLcgMul = 747796405u;
constexpr uint32_t kLcgAdd = 2891336453u;
constexpr int kMaxTile = 8192;
constexpr int kSortThreads = 1024;
constexpr int kMinChunk = 2048;      // keys an order CTA sorts, at least

constexpr int kMaxWindow = 1024;     // keys a round: one a thread
constexpr int kMinWindow = 256;      // the smallest window it adapts to
constexpr int kOverlaySlots = 16384;  // overlay entries of a window, shared
constexpr int kMaxOverlay = 72;      // word writes one key's overlay holds
constexpr int kHashLog = 13;
constexpr int kHashSlots = 1 << kHashLog;  // written-bucket set (u64 slots)
constexpr int kHashBudget = 4096;    // overlay writes a window may insert
// set entries a chain finished alone may insert (its overlay, then its
// direct writes), and the room a round leaves such chains: the set stays
// at most three quarters full
constexpr int kAloneMax = kMaxOverlay + 2 + kMaxKicks;
constexpr int kAloneRoom = kHashSlots * 3 / 4 - kHashBudget;
constexpr int kWarps = kMaxWindow / 32;
constexpr unsigned long long kEmpty = ~0ull;

enum Op : int { kAdd = 0, kRemove = 1 };
enum Stat : int {
  kRounds = 0, kConflictRounds, kCappedRounds, kAloneKeys, kMinCommitted,
  kMaxCommitted, kChainReads, kReads
};

struct Geometry {
  uint32_t bucket_mask;  // n_buckets - 1
  int lg_buckets;        // log2 n_buckets
  uint32_t fp_salt, alt_salt;
};

template <int SB>
__device__ __forceinline__ uint32_t fingerprint(uint32_t h1,
                                                uint32_t fp_salt) {
  const uint32_t fp = (h1 * fp_salt) >> (32 - SB);
  return fp == 0u ? 1u : fp;
}

__device__ __forceinline__ uint32_t alt_bucket(const Geometry& g, uint32_t b,
                                               uint32_t fp) {
  if (g.lg_buckets == 0) return b;
  return b ^ ((fp * g.alt_salt) >> (32 - g.lg_buckets));
}

template <int SB, int SPB>
struct Bucket {
  static constexpr int S = SPB * SB / 32;
  static constexpr int LG_S = log2_of(S);
  static constexpr int SPW = 32 / SB;
  static constexpr uint32_t kMask = (1u << SB) - 1u;
  static constexpr int PHI = S < 4 ? S : 4;
  static_assert(S >= 1 && S % PHI == 0, "a bucket is 1, 2, 4 or 8 words");

  __device__ __forceinline__ static uint32_t lane(const uint32_t* w, int j) {
    return (w[j / SPW] >> (SB * (j % SPW))) & kMask;
  }
  __device__ __forceinline__ static void set_lane(uint32_t* w, int j,
                                                  uint32_t v) {
    const int sh = SB * (j % SPW);
    w[j / SPW] = (w[j / SPW] & ~(kMask << sh)) | (v << sh);
  }
  // read-only load (contains)
  __device__ __forceinline__ static void load(const uint32_t* __restrict__ t,
                                              uint32_t b, uint32_t* w) {
    const uint32_t* p = t + uint64_t(b) * S;
#pragma unroll
    for (int c = 0; c < S / PHI; ++c) Vec<PHI>::load(p + c * PHI, w + c * PHI);
  }
  // a load of a bucket the update writes: from L2 (ld.global.cg), never
  // from an L1 line
  __device__ __forceinline__ static void load_cg(const uint32_t* t,
                                                 uint32_t b, uint32_t* w) {
    const uint32_t* p = t + uint64_t(b) * S;
    if constexpr (S == 1) {
      w[0] = __ldcg(p);
    } else if constexpr (S == 2) {
      const uint2 v = __ldcg(reinterpret_cast<const uint2*>(p));
      w[0] = v.x;
      w[1] = v.y;
    } else {
#pragma unroll
      for (int c = 0; c < S / 4; ++c) {
        const uint4 v = __ldcg(reinterpret_cast<const uint4*>(p) + c);
        w[4 * c] = v.x;
        w[4 * c + 1] = v.y;
        w[4 * c + 2] = v.z;
        w[4 * c + 3] = v.w;
      }
    }
  }
  __device__ __forceinline__ static bool has(const uint32_t* __restrict__ t,
                                             uint32_t b, uint32_t fp) {
    uint32_t w[S];
    load(t, b, w);
    bool hit = false;
#pragma unroll
    for (int j = 0; j < SPB; ++j) hit |= lane(w, j) == fp;
    return hit;
  }
};

template <int SB, int SPB>
__global__ void __launch_bounds__(kThreads)
    cuckoo_contains_kernel(const uint2* __restrict__ keys,
                           const uint32_t* __restrict__ table,
                           bool* __restrict__ out, int64_t n, Geometry g) {
  using Bk = Bucket<SB, SPB>;
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t h1, h2;
  hash_key(keys[i], h1, h2);
  const uint32_t fp = fingerprint<SB>(h1, g.fp_salt);
  const uint32_t b1 = h2 & g.bucket_mask;
  bool hit = Bk::has(table, b1, fp);
  if (!hit) hit = Bk::has(table, alt_bucket(g, b1, fp), fp);
  out[i] = hit;
}

// --- 1. the apply order --------------------------------------------------

// One CTA sorts `chunk` keys (whole tiles) starting at blockIdx.x * chunk:
// sort key (i / tile) << 44 | b1 << 13 | i, i < 8192 the index in the
// chunk, b1 < 2^30, so the order is by tile, then b1, then index (stable).
template <int SB>
__global__ void __launch_bounds__(kSortThreads)
    cuckoo_order_kernel(const uint2* __restrict__ keys,
                        const uint8_t* __restrict__ valid,
                        uint4* __restrict__ order, int64_t n, int tile,
                        int chunk, int sort_len, Geometry g) {
  extern __shared__ uint64_t sort_keys[];          // sort_len
  uint32_t* fps = reinterpret_cast<uint32_t*>(sort_keys + sort_len);
  uint32_t* rngs = fps + chunk;
  const int64_t start = int64_t(blockIdx.x) * chunk;
  const int len = int(n - start < chunk ? n - start : chunk);
  for (int i = threadIdx.x; i < sort_len; i += blockDim.x) {
    if (i < len) {
      uint32_t h1, h2;
      hash_key(keys[start + i], h1, h2);
      const bool ok = valid == nullptr || valid[start + i];
      fps[i] = ok ? fingerprint<SB>(h1, g.fp_salt) : 0u;
      rngs[i] = h1 ^ kSeedAux;
      sort_keys[i] = (uint64_t(i / tile) << 44) |
                     (uint64_t(h2 & g.bucket_mask) << 13) | uint32_t(i);
    } else {
      sort_keys[i] = kEmpty;                       // sorts last
    }
  }
  __syncthreads();
  for (int k = 2; k <= sort_len; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < sort_len; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const uint64_t a = sort_keys[i], b = sort_keys[ixj];
          if ((a > b) == ((i & k) == 0)) {
            sort_keys[i] = b;
            sort_keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int s = threadIdx.x; s < len; s += blockDim.x) {
    const uint64_t pair = sort_keys[s];
    const int i = int(pair & 0x1FFFu);
    order[start + s] = make_uint4(uint32_t(pair >> 13) & 0x7FFFFFFFu, fps[i],
                                  rngs[i], uint32_t(start + i));
  }
}

// --- 2. the windowed apply -----------------------------------------------

// One key's chain, resumable between steps. A step reads bucket b, then
// places, moves to the alternate bucket, kicks, or ends.
struct Chain {
  uint32_t b1, fp;       // the key's primary bucket and fingerprint
  uint32_t b, f, r;      // next bucket, fingerprint carried, victim stream
  uint32_t last;         // the last bucket read
  int kicks, stage, reads, nlog;
  bool done, ok;
};

__device__ __forceinline__ uint32_t hash_slot(uint32_t b) {
  return (b * 0x9E3779B1u) >> (32 - kHashLog);
}

// Record that `pos` writes bucket b: the slot keeps the lowest writer.
__device__ __forceinline__ void hash_insert(unsigned long long* set,
                                            uint32_t b, uint32_t pos) {
  const unsigned long long val = (uint64_t(b) << 32) | pos;
  for (uint32_t h = hash_slot(b);; h = (h + 1) & (kHashSlots - 1)) {
    unsigned long long cur = set[h];
    if (cur == kEmpty) {
      cur = atomicCAS(set + h, kEmpty, val);
      if (cur == kEmpty) return;
    }
    if (uint32_t(cur >> 32) == b) {
      atomicMin(set + h, val);
      return;
    }
  }
}

// The lowest writer of bucket b this round, or ~0 for none.
__device__ __forceinline__ uint32_t hash_writer(
    const unsigned long long* set, uint32_t b) {
  for (uint32_t h = hash_slot(b);; h = (h + 1) & (kHashSlots - 1)) {
    const unsigned long long cur = set[h];
    if (cur == kEmpty) return ~0u;
    if (uint32_t(cur >> 32) == b) return uint32_t(cur);
  }
}

template <int SB, int SPB, int OP, class Read, class Write>
__device__ __forceinline__ void chain_step(Chain& c, const Geometry& g,
                                           Read read, Write write) {
  using Bk = Bucket<SB, SPB>;
  constexpr int lg_spb = log2_of(SPB);
  uint32_t w[Bk::S];
  read(c.b, w);
  c.reads++;
  c.last = c.b;
  int j = 0;
  if (OP == kAdd) {
    while (j < SPB && Bk::lane(w, j) != 0u) ++j;
    if (j < SPB) {
      Bk::set_lane(w, j, c.f);
      write(c.b, j / Bk::SPW, w[j / Bk::SPW]);
      c.done = c.ok = true;
    } else if (c.stage == 0) {
      c.stage = 1;
      c.b = alt_bucket(g, c.b, c.f);
    } else if (c.kicks == kMaxKicks) {
      c.done = true;
      c.ok = false;
    } else {
      const int v = lg_spb == 0 ? 0 : int(c.r >> (32 - lg_spb));
      const uint32_t victim = Bk::lane(w, v);
      Bk::set_lane(w, v, c.f);
      write(c.b, v / Bk::SPW, w[v / Bk::SPW]);
      c.f = victim;
      c.b = alt_bucket(g, c.b, c.f);
      c.r = c.r * kLcgMul + kLcgAdd;
      c.kicks++;
    }
  } else {
    while (j < SPB && Bk::lane(w, j) != c.f) ++j;
    if (j < SPB) {
      Bk::set_lane(w, j, 0u);
      write(c.b, j / Bk::SPW, w[j / Bk::SPW]);
      c.done = c.ok = true;
    } else if (c.stage == 0) {
      c.stage = 1;
      c.b = alt_bucket(g, c.b, c.f);
    } else {
      c.done = true;
      c.ok = false;
    }
  }
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// How a window's validation ended at a key.
enum End : uint32_t { kEndConflict = 0, kEndCapped = 1, kEndBudget = 2 };

// The first set bit at or after `from` of the window's 1024-bit `ending`
// map, or `cnt`; a whole warp evaluates it (lane l reads word l).
__device__ __forceinline__ int next_end(const uint32_t* ending, int from,
                                        int cnt, int lane) {
  uint32_t w = 0u;
  if (lane >= (from >> 5)) {
    w = ending[lane];
    if (lane == (from >> 5)) w &= ~0u << (from & 31);
  }
  const uint32_t any = __ballot_sync(0xffffffffu, w != 0u);
  if (any == 0u) return cnt;
  const int l = __ffs(any) - 1;
  const int pos = (l << 5) + __ffs(__shfl_sync(0xffffffffu, w, l)) - 1;
  return pos < cnt ? pos : cnt;
}

template <int SB, int SPB, int OP>
__global__ void __launch_bounds__(kMaxWindow)
    cuckoo_apply_kernel(const uint4* __restrict__ order, uint32_t* table,
                        bool* __restrict__ flags, int64_t n, int window,
                        int step_cap, Geometry g,
                        long long* __restrict__ stats) {
  using Bk = Bucket<SB, SPB>;
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ unsigned long long smem[];
  unsigned long long* overlay = smem;        // [cap][win], win keys a round
  unsigned long long* set = overlay + kOverlaySlots;
  uint32_t* warp_sum = reinterpret_cast<uint32_t*>(set + kHashSlots);
  uint32_t* ending = warp_sum + kWarps;     // bit t: key t ends the window
  uint32_t* warp_max = ending + kWarps;
  uint32_t* warp_reads = warp_max + kWarps;
  int* alone_inserts = reinterpret_cast<int*>(warp_reads + kWarps);
  uint8_t* reason = reinterpret_cast<uint8_t*>(alone_inserts + 1);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned long long* mine = overlay + t;    // entry e at e * win

  for (int h = t; h < kHashSlots; h += kMaxWindow) set[h] = kEmpty;
  // thread 0 keeps the counters of the rounds; a thread that finishes a
  // chain alone counts it and the reads it took alone
  long long rounds = 0, conflicts = 0, capped_rounds = 0;
  long long min_commit = n, max_commit = 0, longest = 0, spec_reads = 0;
  unsigned long long my_alone = 0, my_extra = 0;
  __syncthreads();

  // the round's window `win` and a key's overlay cap: halved after a round in
  // which a key was capped (its chain longer than the overlay allows),
  // doubled after a round that committed the whole window
  const int min_window = window < kMinWindow ? window : kMinWindow;
  int win = window;
  for (int64_t base = 0; base < n;) {
    const int cnt = int(n - base < win ? n - base : win);
    const int cap = kOverlaySlots / win < kMaxOverlay ? kOverlaySlots / win
                                                      : kMaxOverlay;
    const bool live = t < cnt;
    if (base + cnt + t < n) prefetch_l2(order + base + cnt + t);
    // speculate
    Chain c{};
    uint32_t orig = 0;
    c.done = c.ok = true;
    if (live) {
      const uint4 k = __ldg(order + base + t);
      orig = k.w;
      if (k.y != 0u) {
        c.b1 = c.b = k.x;
        c.fp = c.f = k.y;
        c.r = k.z;
        c.done = c.ok = false;
      }
    }
    auto read_spec = [&](uint32_t b, uint32_t* w) {
      Bk::load_cg(table, b, w);
      for (int e = 0; e < c.nlog; ++e) {
        const unsigned long long ent = mine[e * win];
        const uint32_t a = uint32_t(ent >> 32);
        if ((a >> Bk::LG_S) == b) w[a & (Bk::S - 1)] = uint32_t(ent);
      }
    };
    auto write_spec = [&](uint32_t b, int wi, uint32_t word) {
      mine[c.nlog * win] =
          (uint64_t((b << Bk::LG_S) + uint32_t(wi)) << 32) | word;
      c.nlog++;
    };
    bool capped = false;
    while (!c.done) {
      if (c.reads == step_cap || c.nlog == cap) {
        capped = true;
        break;
      }
      chain_step<SB, SPB, OP>(c, g, read_spec, write_spec);
    }
    const uint32_t key_reads = uint32_t(c.reads);
    // every speculative read is done; was key 0 capped
    int alone_here = __syncthreads_or(t == 0 && capped);
    // a capped key finishes alone, on the table: its overlay stored, the
    // rest of its chain run directly, its writes entered in the set as
    // position `pos`'s
    auto finish_alone = [&](uint32_t pos) {
      const int before = c.reads;
      int inserts = c.nlog;
      for (int e = 0; e < c.nlog; ++e) {
        const unsigned long long ent = mine[e * win];
        const uint32_t a = uint32_t(ent >> 32);
        table[a] = uint32_t(ent);
        hash_insert(set, a >> Bk::LG_S, pos);
      }
      c.nlog = 0;
      auto read_direct = [&](uint32_t b, uint32_t* w) {
        Bk::load_cg(table, b, w);
      };
      auto write_direct = [&](uint32_t b, int wi, uint32_t word) {
        table[(b << Bk::LG_S) + uint32_t(wi)] = word;
        hash_insert(set, b, pos);
        inserts++;
      };
      while (!c.done) chain_step<SB, SPB, OP>(c, g, read_direct, write_direct);
      capped = false;
      my_alone++;
      my_extra += c.reads - before;
      *alone_inserts += inserts;
    };
    // key 0 read only the committed table, with no key before it
    if (t == 0) {
      *alone_inserts = 0;
      if (capped) finish_alone(0u);
    }
    // the hash budget: a prefix sum of the overlay writes by position
    uint32_t incl = (live && !capped) ? uint32_t(c.nlog) : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t v = __shfl_up_sync(kAll, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    incl += __reduce_add_sync(kAll, lane < warp ? warp_sum[lane] : 0u);
    const bool over = live && !capped && incl > uint32_t(kHashBudget);
    if (live && !capped && !over)
      for (int e = 0; e < c.nlog; ++e)
        hash_insert(set, uint32_t(mine[e * win] >> 32) >> Bk::LG_S,
                    uint32_t(t));
    const uint32_t top = __reduce_max_sync(kAll, key_reads);
    const uint32_t sum = __reduce_add_sync(kAll, key_reads);
    if (lane == 0) {
      warp_max[warp] = top;
      warp_reads[warp] = sum;
    }
    __syncthreads();                     // the set is complete
    // validate: a key ends the window where its reads meet an earlier
    // key's write (conflict), past the hash budget, or capped; the keys
    // before the first that ends are committed. A key capped at its step
    // or overlay cap that read no earlier key's write is then first, its
    // chain so far exact: it finishes alone and the window goes on past it,
    // the keys up to the next that ends checked again (against its writes
    // too). A conflict, or a key past the hash budget, ends the round.
    const uint32_t alt = alt_bucket(g, c.b1, c.fp);
    auto conflicted = [&]() {
      if (c.reads == 0) return false;
      auto earlier = [&](uint32_t b) {
        return hash_writer(set, b) < uint32_t(t);
      };
      bool hit = earlier(c.b1) || (c.reads > 1 && earlier(alt)) ||
                 (c.reads > 2 && earlier(c.last));
      for (int e = 0; e < c.nlog && !hit; ++e) {
        const uint32_t b = uint32_t(mine[e * win] >> 32) >> Bk::LG_S;
        if (b != c.b1 && b != alt) hit = earlier(b);
      }
      return hit;
    };
    {
      const bool conflict = live && conflicted();
      const uint32_t ends = __ballot_sync(kAll, conflict || capped || over);
      if (lane == 0) ending[warp] = ends;
      if (conflict || capped || over)
        reason[t] = conflict ? kEndConflict : over ? kEndBudget : kEndCapped;
    }
    __syncthreads();                     // the window's ends are known
    int lo = 0, first = next_end(ending, 0, cnt, lane);
    uint32_t why = kEndConflict;
    while (true) {
      const int then = next_end(ending, first + 1, cnt, lane);
      why = first < cnt ? reason[first] : kEndConflict;
      if (t >= lo && t < first) {       // commit
        for (int e = 0; e < c.nlog; ++e) {
          const unsigned long long ent = mine[e * win];
          table[uint32_t(ent >> 32)] = uint32_t(ent);
        }
        flags[orig] = c.ok;
      }
      if (first == cnt || why != kEndCapped) break;
      if (*alone_inserts + kAloneMax > kAloneRoom) {
        why = kEndBudget;                // no room left in the set
        break;
      }
      alone_here++;
      __syncthreads();                   // the commit is visible
      if (t == first) {
        finish_alone(uint32_t(t));
        flags[orig] = c.ok;
      }
      __syncthreads();                   // its writes and entries are visible
      const bool conflict = live && t > first && t <= then && conflicted();
      const uint32_t hit = __ballot_sync(kAll, conflict);
      if (lane == 0) ending[warp] |= hit;
      if (conflict) reason[t] = kEndConflict;
      lo = first + 1;
      __syncthreads();                   // the ends after it are known
      first = next_end(ending, lo, cnt, lane);
    }
    for (int h = t; h < kHashSlots; h += kMaxWindow) set[h] = kEmpty;
    if (warp == 0) {
      const uint32_t round_max = __reduce_max_sync(kAll, warp_max[lane]);
      const uint32_t round_reads = __reduce_add_sync(kAll, warp_reads[lane]);
      if (lane == 0) {
        rounds++;
        if (first < cnt) (why == kEndConflict ? conflicts : capped_rounds)++;
        min_commit = min(min_commit, (long long)first);
        max_commit = max(max_commit, (long long)first);
        longest += round_max;
        spec_reads += round_reads;
      }
    }
    if (alone_here > 0 || (first < cnt && why == kEndBudget))
      win = win / 2 > min_window ? win / 2 : min_window;
    else if (first == win)
      win = 2 * win < window ? 2 * win : window;
    base += first;
    __syncthreads();                     // the commit is visible
  }
  // the chains finished alone, summed over their threads
  if (t < 2) set[t] = 0ull;
  __syncthreads();
  if (my_alone) {
    atomicAdd(set, my_alone);
    atomicAdd(set + 1, my_extra);
  }
  __syncthreads();
  if (t == 0) {
    stats[kRounds] = rounds;
    stats[kConflictRounds] = conflicts;
    stats[kCappedRounds] = capped_rounds;
    stats[kAloneKeys] = (long long)set[0];
    stats[kMinCommitted] = min_commit;
    stats[kMaxCommitted] = max_commit;
    stats[kChainReads] = longest + (long long)set[1];
    stats[kReads] = spec_reads + (long long)set[1];
  }
}

// next[i] is the word index of the chain's next link; out gets the last
__global__ void chase_kernel(const uint32_t* next, int64_t steps,
                             uint32_t* out) {
  uint32_t i = 0;
  for (int64_t s = 0; s < steps; ++s) i = next[i];
  *out = i;
}

template <int SB, int SPB>
int launch_contains(const uint2* keys, const uint32_t* table, bool* out,
                    int64_t n, const Geometry& g, cudaStream_t stream) {
  const unsigned grid = unsigned((n + kThreads - 1) / kThreads);
  cuckoo_contains_kernel<SB, SPB><<<grid, kThreads, 0, stream>>>(
      keys, table, out, n, g);
  return int(cudaGetLastError());
}

template <class Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(bytes)) != cudaSuccess)
    return int(cudaGetLastError());
  return 0;
}

template <int SB>
int launch_order(const uint2* keys, const uint8_t* valid, uint4* order,
                 int64_t n, int tile, const Geometry& g, cudaStream_t stream) {
  // a chunk of whole tiles, at least kMinChunk keys (tile 1 ... 2048), or
  // one tile; sorted in the next power of two
  const int chunk = tile >= kMinChunk ? tile : (kMinChunk / tile) * tile;
  const int64_t span = n < chunk ? n : chunk;
  int sort_len = 1;
  while (sort_len < span) sort_len <<= 1;
  const size_t bytes = size_t(sort_len) * sizeof(uint64_t) +
                       size_t(chunk) * 2 * sizeof(uint32_t);
  if (int err = allow_smem(cuckoo_order_kernel<SB>, bytes)) return err;
  const int threads = sort_len < kSortThreads ? (sort_len < 32 ? 32 : sort_len)
                                              : kSortThreads;
  const unsigned grid = unsigned((n + chunk - 1) / chunk);
  cuckoo_order_kernel<SB><<<grid, threads, bytes, stream>>>(
      keys, valid, order, n, tile, chunk, sort_len, g);
  return int(cudaGetLastError());
}

template <int SB, int SPB, int OP>
int launch_apply(const uint4* order, uint32_t* table, bool* flags, int64_t n,
                 int window, int step_cap, const Geometry& g,
                 long long* stats, cudaStream_t stream) {
  const size_t bytes = size_t(kOverlaySlots) * 8 +
                       size_t(kHashSlots) * 8 +
                       (4 * kWarps + 1) * sizeof(uint32_t) + kMaxWindow;
  if (int err = allow_smem(cuckoo_apply_kernel<SB, SPB, OP>, bytes))
    return err;
  cuckoo_apply_kernel<SB, SPB, OP><<<1, kMaxWindow, bytes, stream>>>(
      order, table, flags, n, window, step_cap, g, stats);
  return int(cudaGetLastError());
}

template <int SB, int SPB, int OP>
int launch_update(const uint2* keys, const uint8_t* valid, uint32_t* table,
                  bool* flags, uint4* order, long long* stats, int64_t n,
                  int tile, int window, int step_cap, const Geometry& g,
                  cudaStream_t stream) {
  if (int err = launch_order<SB>(keys, valid, order, n, tile, g, stream))
    return err;
  return launch_apply<SB, SPB, OP>(order, table, flags, n, window, step_cap,
                                   g, stats, stream);
}

// One switch over the instantiated (slot_bits, slots_per_bucket) pairs;
// CALL(SB, SPB) is the launch for one pair.
#define CUCKOO_DISPATCH(slot_bits, spb, CALL) \
  do {                                        \
    if ((slot_bits) == 8) {                   \
      switch (spb) {                          \
        case 4:                               \
          return CALL(8, 4);                  \
        case 8:                               \
          return CALL(8, 8);                  \
        case 16:                              \
          return CALL(8, 16);                 \
      }                                       \
    } else if ((slot_bits) == 16) {           \
      switch (spb) {                          \
        case 2:                               \
          return CALL(16, 2);                 \
        case 4:                               \
          return CALL(16, 4);                 \
        case 8:                               \
          return CALL(16, 8);                 \
        case 16:                              \
          return CALL(16, 16);                \
      }                                       \
    }                                         \
    return -1;                                \
  } while (0)

}  // namespace

extern "C" {

// keys: (n, 2) int32 [hi, lo], 8-byte aligned; table: (n_words,) int32,
// 16-byte aligned; out: (n,) bool; slot_bits 8 with spb 4/8/16, or 16 with
// spb 2/4/8/16.
int cuckoo_contains(const void* keys, const void* table, void* out,
                    long long n, unsigned bucket_mask, int lg_buckets,
                    int slot_bits, int spb, unsigned fp_salt,
                    unsigned alt_salt, void* stream) {
  if (n <= 0) return 0;
  const Geometry g{bucket_mask, lg_buckets, fp_salt, alt_salt};
  const uint2* k = static_cast<const uint2*>(keys);
  const uint32_t* t = static_cast<const uint32_t*>(table);
  bool* o = static_cast<bool*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(SB, SPB) launch_contains<SB, SPB>(k, t, o, n, g, st)
  CUCKOO_DISPATCH(slot_bits, spb, CALL);
#undef CALL
}

// valid: (n,) uint8 or null (every key valid); table updated in place;
// flags: (n,) bool (ok for add, found for remove); order: (n,) 16-byte
// scratch; stats: (8,) int64 counters (see Stat); tile in [1, 8192], window
// in [1, 1024] (the first round's and the largest), step_cap >= 1, n <
// 2^31; op: 0 add, 1 remove. Launches the order kernel, then the apply
// kernel.
int cuckoo_update(const void* keys, const void* valid, void* table,
                  void* flags, void* order, void* stats, long long n,
                  int tile, int window, int step_cap, unsigned bucket_mask,
                  int lg_buckets, int slot_bits, int spb, unsigned fp_salt,
                  unsigned alt_salt, int op, void* stream) {
  if (n <= 0) return 0;
  if (tile < 1 || tile > kMaxTile || window < 1 || window > kMaxWindow ||
      step_cap < 1 || n >= (1ll << 31) || (op != kAdd && op != kRemove))
    return -1;
  const Geometry g{bucket_mask, lg_buckets, fp_salt, alt_salt};
  const uint2* k = static_cast<const uint2*>(keys);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  uint32_t* t = static_cast<uint32_t*>(table);
  bool* fl = static_cast<bool*>(flags);
  uint4* ord = static_cast<uint4*>(order);
  long long* s = static_cast<long long*>(stats);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(SB, SPB)                                                     \
  (op == kAdd ? launch_update<SB, SPB, kAdd>(k, v, t, fl, ord, s, n, tile, \
                                             window, step_cap, g, st)     \
              : launch_update<SB, SPB, kRemove>(k, v, t, fl, ord, s, n,   \
                                                tile, window, step_cap, g, \
                                                st))
  CUCKOO_DISPATCH(slot_bits, spb, CALL);
#undef CALL
}

// next: (n_words,) int32 of word indices forming a chain from word 0; out:
// (1,) int32. One thread takes `steps` dependent loads.
int cuckoo_chase(const void* next, long long steps, void* out, void* stream) {
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(next), steps, static_cast<uint32_t*>(out));
  return int(cudaGetLastError());
}

}  // extern "C"
