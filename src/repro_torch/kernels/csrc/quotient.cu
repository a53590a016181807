// Counting quotient filter kernels for Hopper (sm_90a): bulk contains and the
// canonical-rebuild bulk add / remove.
//
// Replaces the Pallas entry points of repro/kernels/quotientfilter.py:
//   quotient_contains_kernel<SB>   <- contains_vmem (_contains_kernel, which
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
// * the update: the words are a function of the stored fingerprint
//   multiset, and the flags of the batch order only (an add admits the
//   first room = n - 1 - stored valid keys; a remove finds a key when its
//   rank among the batch's requests for its fingerprint is below the stored
//   count), so one rebuild a call gives the reference's table and flags for
//   every tile. It runs as slot-parallel and key-parallel kernels around
//   multi-block scans (reduce, scan of the block sums, scan with the
//   offsets; no library sort or scan):
//    1. slots_kernel: the first empty slot a0 and the stored count;
//    2. a scan, from just past a0, of (run start, occupied) pairs: the k-th
//       run belongs to the k-th occupied slot; old_runs_kernel gives each
//       quotient's old run (start, length);
//    3. hash_kernel and, for add, a scan of the valid mask: ok = valid &
//       (valid keys up to it <= room); each admitted key (ok for add, valid
//       for remove) counts into its quotient's bucket;
//    4. a scan of the bucket counts and scatter_kernel: the admitted keys'
//       indices grouped by quotient;
//    5. merge_kernel, one thread a quotient: add sorts its bucket by
//       remainder; remove finds each request while copies of its remainder
//       are left, in batch order (the rank is counted only when a remainder
//       has more requests than copies); each writes its new count c[q];
//    6. a scan of c - 1 and argmin_kernel: the anchor, the first argmin (it
//       stays empty, so no run wraps from there on);
//    7. a scan, from just past the anchor, of (c, rq) under (s, m) . (s',
//       m') = (s + s', max(m, m' - s)): run rq starts at C[rq] + max over
//       nonempty rq' <= rq of (rq' - C[rq']), C the exclusive prefix of c
//       (the reference's pos_j = j + cummax(rq_j - j) at a run's first
//       element);
//    8. write_kernel, one thread a quotient: the merged remainders (add:
//       the old run and the sorted bucket; remove: the old run less the
//       found copies) at run start + t with continuation and shifted bits,
//       and the occupied bit at q, ORed into a zeroed table (neighbouring
//       runs share words); the new table is then copied over the old one.
//   Bound: the bytes of the keys, valid bytes and flags, and the table read
//   once and written once; the scans and per-slot arrays move more (20 or
//   23 launches a call).
// * the contains' table pass: steps 1-2 once a call give every quotient's
//   run start, then lookup_kernel compares a key's remainder along its own
//   run only, with no walk. The walk's cost grows with the cluster length,
//   as 1 / (1 - load)^2, the pass's with the table: for a batch of at least
//   n_slots / 16 keys, choose_kernel picks one from the load that step 1
//   counted, on the card, and the other path's launches return at once.
// * merge and resize (not TPU kernels: the JAX package computes them
//   outside Pallas) run the same stages: quotient_decode (steps 1-2, then
//   emit_kernel writes each stored fingerprint at its slot) and the add
//   with those fingerprints as input (fps_in), into the other table
//   (merge) or an empty table of the new geometry (resize).
//
// C interface for ctypes: each entry point returns the first CUDA error of
// its launches (0 when all launched), or -1 for arguments it does not take.

#include <cstring>

#include "bloom_common.cuh"

namespace {

constexpr int kScanThreads = 512;
constexpr int kScanItems = 8;
constexpr long long kScanTile = kScanThreads * kScanItems;
constexpr int kNeg = -(1 << 30);        // below every rq - C (n <= 2^29)

enum Op : int { kAdd = 0, kRemove = 1 };

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
  __device__ __forceinline__ static void put(uint32_t* t, uint32_t s,
                                             uint32_t v) {
    atomicOr(t + s / SPW, v << (SB * (s % SPW)));
  }
};

__device__ __forceinline__ uint32_t fingerprint(uint2 key, const Geometry& g) {
  const uint32_t h = xxh32_from_products(key.y * P3, key.x * P3, kSeedPattern);
  return (h * g.fp_salt) >> (32 - g.p_bits);
}

__device__ __forceinline__ uint32_t rem_mask(const Geometry& g) {
  return (1u << g.r_bits) - 1u;
}

// a launch with a gate runs only while the flag it points to is set
__device__ __forceinline__ bool closed(const unsigned long long* gate) {
  return gate != nullptr && *gate == 0;
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

template <int SB>
__global__ void __launch_bounds__(kThreads)
    quotient_contains_kernel(const uint2* __restrict__ keys,
                             const uint32_t* __restrict__ table,
                             bool* __restrict__ out, int64_t n, Geometry g,
                             const unsigned long long* gate) {
  using L = Lanes<SB>;
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n || closed(gate)) return;
  const uint32_t fp = fingerprint(keys[i], g);
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
  out[i] = hit;
}

// ---------------------------------------------------------------------------
// Multi-block scans: reduce each tile, scan the tile totals in one block,
// scan each tile again from its offset. A Src functor gives element i, a Dst
// functor takes (i, exclusive prefix, inclusive prefix).
// ---------------------------------------------------------------------------

template <class T>
__device__ __forceinline__ T shfl_up8(T v, int d) {
  static_assert(sizeof(T) == 8, "scan values are 8 bytes");
  long long b;
  memcpy(&b, &v, 8);
  b = __shfl_up_sync(0xFFFFFFFFu, b, d);
  T r;
  memcpy(&r, &b, 8);
  return r;
}

struct SumOp {
  using T = long long;
  __device__ static T identity() { return 0; }
  __device__ static T combine(T a, T b) { return a + b; }
};

struct RunPos {
  int s;   // slots taken
  int m;   // max over nonempty runs of (rq - slots before rq), relative
};

struct RunPosOp {
  using T = RunPos;
  __device__ static T identity() { return {0, kNeg}; }
  __device__ static T combine(T a, T b) {
    return {a.s + b.s, max(a.m, b.m - a.s)};
  }
};

// Thread t holds items t * kScanItems ... of the block's tile; each becomes
// the combine of the tile's items before it. Returns the tile's total.
template <class Op>
__device__ typename Op::T block_scan(typename Op::T (&x)[kScanItems]) {
  using T = typename Op::T;
  constexpr int kWarps = kScanThreads / 32;
  __shared__ T warp_total[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T acc = Op::identity();
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    const T v = x[k];
    x[k] = acc;
    acc = Op::combine(acc, v);
  }
  T inc = acc;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = shfl_up8(inc, d);
    if (lane >= d) inc = Op::combine(y, inc);
  }
  T lane_excl = shfl_up8(inc, 1);
  if (lane == 0) lane_excl = Op::identity();
  if (lane == 31) warp_total[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T w = lane < kWarps ? warp_total[lane] : Op::identity();
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T y = shfl_up8(w, d);
      if (lane >= d) w = Op::combine(y, w);
    }
    if (lane < kWarps) warp_total[lane] = w;
  }
  __syncthreads();
  const T before = Op::combine(
      warp == 0 ? Op::identity() : warp_total[warp - 1], lane_excl);
  const T total = warp_total[kWarps - 1];
  __syncthreads();                         // warp_total is used again
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) x[k] = Op::combine(before, x[k]);
  return total;
}

template <class Op, class Src>
__global__ void __launch_bounds__(kScanThreads)
    scan_reduce_kernel(Src src, long long n, typename Op::T* aggs,
                       const unsigned long long* gate) {
  using T = typename Op::T;
  if (closed(gate)) return;
  const long long base = (long long)blockIdx.x * kScanTile +
                         (long long)threadIdx.x * kScanItems;
  T x[kScanItems];
#pragma unroll
  for (int k = 0; k < kScanItems; ++k)
    x[k] = base + k < n ? src(base + k) : Op::identity();
  const T total = block_scan<Op>(x);
  if (threadIdx.x == 0) aggs[blockIdx.x] = total;
}

template <class Op>
__global__ void __launch_bounds__(kScanThreads)
    scan_aggs_kernel(typename Op::T* aggs, long long nb,
                     const unsigned long long* gate) {
  using T = typename Op::T;
  if (closed(gate)) return;
  T carry = Op::identity();
  for (long long c = 0; c < nb; c += kScanTile) {
    const long long base = c + (long long)threadIdx.x * kScanItems;
    T x[kScanItems];
#pragma unroll
    for (int k = 0; k < kScanItems; ++k)
      x[k] = base + k < nb ? aggs[base + k] : Op::identity();
    const T total = block_scan<Op>(x);
#pragma unroll
    for (int k = 0; k < kScanItems; ++k)
      if (base + k < nb) aggs[base + k] = Op::combine(carry, x[k]);
    carry = Op::combine(carry, total);
  }
}

template <class Op, class Src, class Dst>
__global__ void __launch_bounds__(kScanThreads)
    scan_apply_kernel(Src src, Dst dst, long long n,
                      const typename Op::T* aggs,
                      const unsigned long long* gate) {
  using T = typename Op::T;
  if (closed(gate)) return;
  const long long base = (long long)blockIdx.x * kScanTile +
                         (long long)threadIdx.x * kScanItems;
  T x[kScanItems], raw[kScanItems];
#pragma unroll
  for (int k = 0; k < kScanItems; ++k)
    raw[k] = x[k] = base + k < n ? src(base + k) : Op::identity();
  block_scan<Op>(x);
  const T off = aggs[blockIdx.x];
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    if (base + k < n) {
      const T e = Op::combine(off, x[k]);
      dst(base + k, e, Op::combine(e, raw[k]));
    }
  }
}

long long scan_tiles(long long n) { return (n + kScanTile - 1) / kScanTile; }

template <class Op, class Src, class Dst>
void run_scan(Src src, Dst dst, long long n, typename Op::T* aggs,
              cudaStream_t st, const unsigned long long* gate = nullptr) {
  const long long nb = scan_tiles(n);
  scan_reduce_kernel<Op><<<unsigned(nb), kScanThreads, 0, st>>>(src, n, aggs,
                                                                 gate);
  scan_aggs_kernel<Op><<<1, kScanThreads, 0, st>>>(aggs, nb, gate);
  scan_apply_kernel<Op><<<unsigned(nb), kScanThreads, 0, st>>>(src, dst, n,
                                                                aggs, gate);
}

// ---------------------------------------------------------------------------
// The update's stages
// ---------------------------------------------------------------------------

// scal[0]: the old table's first empty slot; scal[1]: its in-use slots;
// scal[2]: (P + n) << 32 | q of the first argmin of P = cumsum(c - 1);
// scal[3] / scal[4]: the contains' table pass / cluster walk chosen
__global__ void init_scalars_kernel(unsigned long long* scal,
                                    unsigned long long n) {
  scal[0] = n;
  scal[1] = 0;
  scal[2] = ~0ull;
}

// The contains' choice, on the card (no host sync): the table pass when
//   n_keys * (walk(load) - lookup) > decode * n_slots,
// walk(load) = kWalkNs / (1 - load)^2 a key (a linear-probing cluster
// grows as 1 / (1 - load)^2), from the load that slots_kernel counted.
// Device ns measured on an H100 80GB HBM3 at 700 W (chip_smoke.py
// --profile and phase 4f: walks of 0.029 ns a key at load 0.5 and 0.60-0.67
// at 0.9, lookups of 0.078 ns a key, decodes of 0.023 ns a slot).
constexpr double kWalkNs = 0.0065;
constexpr double kLookupNs = 0.078;
constexpr double kDecodeNs = 0.023;

__global__ void choose_kernel(unsigned long long* scal, long long n_keys,
                              long long n_slots) {
  const double free = fmax(1.0 - double(scal[1]) / double(n_slots), 1e-3);
  const bool pass = double(n_keys) * (kWalkNs / (free * free) - kLookupNs) >
                    kDecodeNs * double(n_slots);
  scal[3] = pass;
  scal[4] = !pass;
}

// the first empty slot, 0 when there is none (jnp.argmax of all False)
__device__ __forceinline__ uint32_t first_empty(const unsigned long long* scal,
                                                uint32_t mask) {
  const unsigned long long a = scal[0];
  return a > mask ? 0u : uint32_t(a);
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xFFFFFFFFu, v, d);
    v = o < v ? o : v;
  }
  return v;
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, d);
  return v;
}

template <int SB>
__global__ void __launch_bounds__(kThreads)
    slots_kernel(const uint32_t* __restrict__ t, uint32_t mask,
                 unsigned long long* scal) {
  using L = Lanes<SB>;
  __shared__ unsigned long long smin[kThreads / 32], ssum[kThreads / 32];
  unsigned long long first = ~0ull, used = 0;
  const unsigned long long words = ((unsigned long long)mask + 1) / L::SPW;
  for (unsigned long long w = (unsigned long long)blockIdx.x * kThreads +
                              threadIdx.x;
       w < words; w += (unsigned long long)gridDim.x * kThreads) {
    const uint32_t word = __ldg(t + w);            // a word's lanes at once
#pragma unroll
    for (int j = 0; j < L::SPW; ++j) {
      if ((word >> (SB * j)) & L::kMeta) {
        ++used;
      } else if (w * L::SPW + j < first) {
        first = w * L::SPW + j;
      }
    }
  }
  first = warp_min(first);
  used = warp_sum(used);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    smin[warp] = first;
    ssum[warp] = used;
  }
  __syncthreads();
  if (warp == 0) {
    first = lane < kThreads / 32 ? smin[lane] : ~0ull;
    used = lane < kThreads / 32 ? ssum[lane] : 0;
    first = warp_min(first);
    used = warp_sum(used);
    if (lane == 0) {
      atomicMin(scal, first);
      atomicAdd(scal + 1, used);
    }
  }
}

// rotated index i (from just past the first empty slot): (run start,
// occupied) as (1 << 32, 1) counts
template <int SB>
struct DecodeSrc {
  const uint32_t* t;
  const unsigned long long* scal;
  uint32_t mask;
  __device__ long long operator()(long long i) const {
    using L = Lanes<SB>;
    const uint32_t s = (uint32_t(i) + first_empty(scal, mask) + 1u) & mask;
    const uint32_t l = L::get(t, s);
    const bool run_start = (l & L::kMeta) && !(l & L::kCont);
    return ((long long)run_start << 32) | (long long)((l & L::kOcc) != 0);
  }
};

template <int SB>
struct DecodeDst {
  const uint32_t* t;
  const unsigned long long* scal;
  uint32_t mask;
  int* start_of_rank;    // run k -> its rotated start
  int* rank_of_q;        // occupied q -> k
  __device__ void operator()(long long i, long long excl, long long) const {
    using L = Lanes<SB>;
    const uint32_t s = (uint32_t(i) + first_empty(scal, mask) + 1u) & mask;
    const uint32_t l = L::get(t, s);
    if ((l & L::kMeta) && !(l & L::kCont))
      start_of_rank[excl >> 32] = int(i);
    if (l & L::kOcc) rank_of_q[s] = int(excl & 0xFFFFFFFFll);
  }
};

// each quotient's old run: its first slot and length (0 when unoccupied);
// old_start is rank_of_q's storage, read then written by the same thread
template <int SB>
__global__ void __launch_bounds__(kThreads)
    old_runs_kernel(const uint32_t* __restrict__ t, uint32_t mask,
                    const unsigned long long* scal,
                    const int* __restrict__ start_of_rank, int* old_start,
                    int* __restrict__ old_len,
                    const unsigned long long* gate) {
  using L = Lanes<SB>;
  if (closed(gate)) return;        // a capped grid: a closed launch is cheap
  for (long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
       q <= mask; q += (long long)gridDim.x * kThreads) {
    if (!(L::get(t, uint32_t(q)) & L::kOcc)) {
      old_len[q] = 0;
      continue;
    }
    const uint32_t s0 = (uint32_t(start_of_rank[old_start[q]]) +
                         first_empty(scal, mask) + 1u) & mask;
    old_start[q] = int(s0);
    int len = 1;
    while (L::get(t, (s0 + uint32_t(len)) & mask) & L::kCont) ++len;
    old_len[q] = len;
  }
}

// the stored fingerprints, each at its slot: fps[s] = q << r | rem for the
// slots of q's run (fps and valid zeroed before)
template <int SB>
__global__ void __launch_bounds__(kThreads)
    emit_kernel(const uint32_t* __restrict__ t, const int* __restrict__ os,
                const int* __restrict__ ol, uint32_t* __restrict__ fps,
                uint8_t* __restrict__ valid, uint32_t mask, int r_bits) {
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (q > mask) return;
  const uint32_t rm = (1u << r_bits) - 1u;
  for (int j = 0; j < ol[q]; ++j) {
    const uint32_t s = (uint32_t(os[q]) + uint32_t(j)) & mask;
    fps[s] = (uint32_t(q) << r_bits) | (Lanes<SB>::get(t, s) & rm);
    valid[s] = 1;
  }
}

// the table pass's contains: a key's run starts at run_start[q]
template <int SB>
__global__ void __launch_bounds__(kThreads)
    lookup_kernel(const uint2* __restrict__ keys,
                  const uint32_t* __restrict__ table,
                  const int* __restrict__ run_start, bool* __restrict__ out,
                  int64_t n, Geometry g, const unsigned long long* gate) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n || closed(gate)) return;
  const uint32_t fp = fingerprint(keys[i], g);
  const uint32_t q = fp >> g.r_bits;
  out[i] = (Lanes<SB>::get(table, q) & Lanes<SB>::kOcc) &&
           run_holds<SB>(table, uint32_t(__ldg(run_start + q)),
                         fp & rem_mask(g), g);
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
    hash_kernel(const uint2* __restrict__ keys,
                const uint32_t* __restrict__ fps_in,
                const uint8_t* __restrict__ valid, uint32_t* __restrict__ fps,
                bool* __restrict__ flags, int* __restrict__ hist, int64_t n,
                Geometry g) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t fp = fps_in != nullptr ? fps_in[i] : fingerprint(keys[i], g);
  fps[i] = fp;
  if (valid != nullptr && !valid[i]) {
    flags[i] = true;                      // a masked slot is a no-op
  } else if (OP == kRemove) {
    atomicAdd(hist + (fp >> g.r_bits), 1);
  }
}

struct ValidSrc {
  const uint8_t* valid;
  __device__ long long operator()(long long i) const {
    return valid == nullptr ? 1 : (valid[i] != 0);
  }
};

// add: ok = valid & (valid keys up to i <= room), room = n - 1 - stored
struct AdmitDst {
  const uint8_t* valid;
  const uint32_t* fps;
  const unsigned long long* scal;
  bool* flags;
  int* hist;
  uint32_t mask;
  int r_bits;
  __device__ void operator()(long long i, long long, long long incl) const {
    const bool v = valid == nullptr || valid[i];
    const long long room = (long long)mask - (long long)scal[1];
    const bool ok = v && incl <= room;
    flags[i] = ok || !v;
    if (ok) atomicAdd(hist + (fps[i] >> r_bits), 1);
  }
};

struct IntSrc {
  const int* a;
  int minus;
  __device__ long long operator()(long long i) const { return a[i] - minus; }
};

struct ExclDst {                 // a[i] = exclusive prefix (in place is safe)
  int* a;
  __device__ void operator()(long long i, long long excl, long long) const {
    a[i] = int(excl);
  }
};

struct InclDst {
  int* a;
  __device__ void operator()(long long i, long long, long long incl) const {
    a[i] = int(incl);
  }
};

// off[q] holds bucket q's start; after the atomics, its end
template <int OP>
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(const uint8_t* __restrict__ valid,
                   const bool* __restrict__ flags,
                   const uint32_t* __restrict__ fps, int* __restrict__ off,
                   int* __restrict__ bidx, int64_t n, int r_bits) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const bool v = valid == nullptr || valid[i];
  if (v && (OP == kRemove || flags[i]))
    bidx[atomicAdd(off + (fps[i] >> r_bits), 1)] = int(i);
}

__device__ __forceinline__ int bucket_lo(const int* off, long long q) {
  return q ? off[q - 1] : 0;
}

template <int SB, int OP>
__global__ void __launch_bounds__(kThreads)
    merge_kernel(const uint32_t* __restrict__ t,
                 const uint32_t* __restrict__ fps,
                 const int* __restrict__ off, int* __restrict__ bidx,
                 const int* __restrict__ old_start,
                 const int* __restrict__ old_len, int* __restrict__ cnt,
                 bool* __restrict__ flags, uint32_t mask, int r_bits) {
  using L = Lanes<SB>;
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (q > mask) return;
  const int lo = bucket_lo(off, q), hi = off[q], len = old_len[q];
  const uint32_t rm = (1u << r_bits) - 1u;
  if (OP == kAdd) {                     // sort the bucket by remainder
    for (int a = lo + 1; a < hi; ++a) {
      const int x = bidx[a];
      const uint32_t rx = fps[x] & rm;
      int b = a;
      while (b > lo && (fps[bidx[b - 1]] & rm) > rx) {
        bidx[b] = bidx[b - 1];
        --b;
      }
      bidx[b] = x;
    }
    cnt[q] = len + (hi - lo);
    return;
  }
  const uint32_t s0 = uint32_t(old_start[q]);
  int found_total = 0;
  // short data-dependent loops: unrolling them spills (u32 lanes)
#pragma unroll 1
  for (int e = lo; e < hi; ++e) {
    const int idx = bidx[e];
    const uint32_t v = fps[idx] & rm;
    int stored = 0;
#pragma unroll 1
    for (int j = 0; j < len; ++j)
      stored += (L::get(t, (s0 + uint32_t(j)) & mask) & rm) == v;
    int req = 0, rank = 0;
#pragma unroll 1
    for (int f = lo; f < hi; ++f) {
      if ((fps[bidx[f]] & rm) == v) {
        ++req;
        rank += bidx[f] < idx;
      }
    }
    const bool found = req <= stored || rank < stored;
    flags[idx] = found;
    found_total += found;
  }
  cnt[q] = len - found_total;
}

// the first argmin of p: atomicMin of (p + n) << 32 | q
__global__ void __launch_bounds__(kThreads)
    argmin_kernel(const int* __restrict__ p, uint32_t mask,
                  unsigned long long* scal) {
  __shared__ unsigned long long smin[kThreads / 32];
  unsigned long long best = ~0ull;
  const unsigned long long n = (unsigned long long)mask + 1;
  for (unsigned long long q = (unsigned long long)blockIdx.x * kThreads +
                              threadIdx.x;
       q < n; q += (unsigned long long)gridDim.x * kThreads) {
    const unsigned long long key =
        ((unsigned long long)((long long)p[q] + (long long)n) << 32) | q;
    best = key < best ? key : best;
  }
  best = warp_min(best);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) smin[warp] = best;
  __syncthreads();
  if (warp == 0) {
    best = warp_min(lane < kThreads / 32 ? smin[lane] : ~0ull);
    if (lane == 0) atomicMin(scal + 2, best);
  }
}

__device__ __forceinline__ uint32_t anchor_of(const unsigned long long* scal) {
  return uint32_t(scal[2] & 0xFFFFFFFFull);
}

struct PosSrc {
  const int* cnt;
  const unsigned long long* scal;
  uint32_t mask;
  __device__ RunPos operator()(long long rq) const {
    const uint32_t q = (uint32_t(rq) + anchor_of(scal) + 1u) & mask;
    const int c = cnt[q];
    return {c, c > 0 ? int(rq) : kNeg};
  }
};

struct PosDst {
  const int* cnt;
  const unsigned long long* scal;
  uint32_t mask;
  int* new_start;
  __device__ void operator()(long long rq, RunPos, RunPos incl) const {
    const uint32_t a = anchor_of(scal);
    const uint32_t q = (uint32_t(rq) + a + 1u) & mask;
    const int c = cnt[q];
    if (c > 0) {
      const int start = (incl.s - c) + incl.m;
      new_start[q] = int((uint32_t(start) + a + 1u) & mask);
    }
  }
};

template <int SB, int OP>
__global__ void __launch_bounds__(kThreads)
    write_kernel(const uint32_t* __restrict__ t, uint32_t* nt,
                 const uint32_t* __restrict__ fps, const int* __restrict__ off,
                 const int* __restrict__ bidx,
                 const int* __restrict__ old_start,
                 const int* __restrict__ old_len, const int* __restrict__ cnt,
                 const int* __restrict__ new_start, uint32_t mask,
                 int r_bits) {
  using L = Lanes<SB>;
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (q > mask || cnt[q] == 0) return;
  const uint32_t rm = (1u << r_bits) - 1u;
  const uint32_t p0 = uint32_t(new_start[q]), s0 = uint32_t(old_start[q]);
  const int lo = bucket_lo(off, q), hi = off[q], len = old_len[q];
  uint32_t t_out = 0;
  auto emit = [&](uint32_t rem) {
    const uint32_t p = (p0 + t_out) & mask;
    L::put(nt, p, rem | (t_out ? L::kCont : 0u) |
                      (p != uint32_t(q) ? L::kShift : 0u));
    ++t_out;
  };
  auto old_rem = [&](int j) {
    return L::get(t, (s0 + uint32_t(j)) & mask) & rm;
  };
  if (OP == kAdd) {                    // merge two ascending lists
    int i = 0, j = lo;
    while (i < len || j < hi) {
      const uint32_t ro = i < len ? old_rem(i) : 0xFFFFFFFFu;
      const uint32_t rb = j < hi ? (fps[bidx[j]] & rm) : 0xFFFFFFFFu;
      if (ro <= rb) {
        emit(ro);
        ++i;
      } else {
        emit(rb);
        ++j;
      }
    }
  } else {                              // the old run less the found copies
    int i = 0;
    while (i < len) {
      const uint32_t v = old_rem(i);
      int same = 1;
      while (i + same < len && old_rem(i + same) == v) ++same;
      int req = 0;
      for (int f = lo; f < hi; ++f) req += (fps[bidx[f]] & rm) == v;
      for (int k = min(req, same); k < same; ++k) emit(v);
      i += same;
    }
  }
  L::put(nt, uint32_t(q), L::kOcc);
}

#define QF_CHECK()                                   \
  do {                                               \
    const cudaError_t e_ = cudaGetLastError();       \
    if (e_ != cudaSuccess) return int(e_);           \
  } while (0)

unsigned grid_of(long long n) {
  return unsigned((n + kThreads - 1) / kThreads);
}

// step 1 of the update: the first empty slot and the stored count
template <int SB>
void launch_slots(const uint32_t* table, const Geometry& g,
                  unsigned long long* scal, cudaStream_t st) {
  const long long n = (long long)g.mask + 1;
  const unsigned slot_grid = grid_of(n);
  init_scalars_kernel<<<1, 1, 0, st>>>(scal, (unsigned long long)n);
  slots_kernel<SB><<<slot_grid < 1024 ? slot_grid : 1024, kThreads, 0, st>>>(
      table, g.mask, scal);
}

// step 2: each quotient's run in `table` (os: first slot, ol: length),
// from the slot-parallel scan; sr is scratch
template <int SB>
int launch_runs(const uint32_t* table, const Geometry& g, int* sr, int* os,
                int* ol, long long* aggs, unsigned long long* scal,
                cudaStream_t st, const unsigned long long* gate = nullptr) {
  const long long n = (long long)g.mask + 1;
  run_scan<SumOp>(DecodeSrc<SB>{table, scal, g.mask},
                  DecodeDst<SB>{table, scal, g.mask, sr, os}, n, aggs, st,
                  gate);
  const unsigned grid = grid_of(n) < 8192 ? grid_of(n) : 8192;
  old_runs_kernel<SB><<<grid, kThreads, 0, st>>>(table, g.mask, scal, sr, os,
                                                 ol, gate);
  QF_CHECK();
  return 0;
}

template <int SB>
int launch_decode(const uint32_t* table, const Geometry& g, int* sr, int* os,
                  int* ol, long long* aggs, unsigned long long* scal,
                  cudaStream_t st) {
  launch_slots<SB>(table, g, scal, st);
  return launch_runs<SB>(table, g, sr, os, ol, aggs, scal, st);
}

enum ContainsMode : int { kWalk = 0, kPass = 1, kAuto = 2 };

// the cluster walk, the table pass, or the choice between them on the card
template <int SB>
int launch_contains(const uint2* keys, const uint32_t* table, bool* out,
                    int64_t n, const Geometry& g, int mode, int* ws_slots,
                    long long* aggs, unsigned long long* scal,
                    cudaStream_t st) {
  const long long slots = (long long)g.mask + 1;
  const unsigned long long* walk_gate = mode == kAuto ? scal + 4 : nullptr;
  const unsigned long long* pass_gate = mode == kAuto ? scal + 3 : nullptr;
  if (mode != kWalk) {
    launch_slots<SB>(table, g, scal, st);
    if (mode == kAuto) choose_kernel<<<1, 1, 0, st>>>(scal, n, slots);
  }
  if (mode != kPass)
    quotient_contains_kernel<SB><<<grid_of(n), kThreads, 0, st>>>(
        keys, table, out, n, g, walk_gate);
  if (mode != kWalk) {
    int* const os = ws_slots + slots;
    const int err = launch_runs<SB>(table, g, ws_slots, os,
                                    ws_slots + 2 * slots, aggs, scal, st,
                                    pass_gate);
    if (err) return err;
    lookup_kernel<SB><<<grid_of(n), kThreads, 0, st>>>(keys, table, os, out,
                                                       n, g, pass_gate);
  }
  return int(cudaGetLastError());
}

template <int SB>
int launch_decode_fingerprints(const uint32_t* table, uint32_t* fps,
                               uint8_t* valid, const Geometry& g,
                               int* ws_slots, long long* aggs,
                               unsigned long long* scal, cudaStream_t st) {
  const long long n = (long long)g.mask + 1;
  int* const os = ws_slots + n;
  int* const ol = ws_slots + 2 * n;
  cudaMemsetAsync(fps, 0, size_t(n) * 4, st);
  cudaMemsetAsync(valid, 0, size_t(n), st);
  const int err = launch_decode<SB>(table, g, ws_slots, os, ol, aggs, scal,
                                    st);
  if (err) return err;
  emit_kernel<SB><<<grid_of(n), kThreads, 0, st>>>(table, os, ol, fps, valid,
                                                   g.mask, g.r_bits);
  return int(cudaGetLastError());
}

template <int SB, int OP>
int launch_update(const uint2* keys, const uint32_t* fps_in,
                  const uint8_t* valid, uint32_t* table,
                  uint32_t* nt, bool* flags, int64_t n_keys, const Geometry& g,
                  int* ws_slots, int* ws_keys, long long* aggs,
                  unsigned long long* scal, cudaStream_t st) {
  const long long n = (long long)g.mask + 1;
  const int words = int(n / (32 / SB));
  int* const sr = ws_slots;               // start_of_rank, then bucket offsets
  int* const os = ws_slots + n;           // rank_of_q, then old run start
  int* const ol = ws_slots + 2 * n;       // old run length
  int* const cn = ws_slots + 3 * n;       // new count
  int* const ns = ws_slots + 4 * n;       // cumsum(c - 1), then new run start
  uint32_t* const fps = reinterpret_cast<uint32_t*>(ws_keys);
  int* const bidx = ws_keys + n_keys;
  const unsigned slot_grid = grid_of(n);
  const unsigned reduce_grid = slot_grid < 1024 ? slot_grid : 1024;

  cudaMemsetAsync(nt, 0, size_t(words) * 4, st);
  const int err = launch_decode<SB>(table, g, sr, os, ol, aggs, scal, st);
  if (err) return err;
  cudaMemsetAsync(sr, 0, size_t(n) * 4, st);         // bucket counts
  hash_kernel<OP><<<grid_of(n_keys), kThreads, 0, st>>>(
      keys, fps_in, valid, fps, flags, sr, n_keys, g);
  if (OP == kAdd)
    run_scan<SumOp>(ValidSrc{valid},
                    AdmitDst{valid, fps, scal, flags, sr, g.mask, g.r_bits},
                    n_keys, aggs, st);
  run_scan<SumOp>(IntSrc{sr, 0}, ExclDst{sr}, n, aggs, st);
  scatter_kernel<OP><<<grid_of(n_keys), kThreads, 0, st>>>(
      valid, flags, fps, sr, bidx, n_keys, g.r_bits);
  merge_kernel<SB, OP><<<slot_grid, kThreads, 0, st>>>(
      table, fps, sr, bidx, os, ol, cn, flags, g.mask, g.r_bits);
  QF_CHECK();
  run_scan<SumOp>(IntSrc{cn, 1}, InclDst{ns}, n, aggs, st);
  argmin_kernel<<<reduce_grid, kThreads, 0, st>>>(ns, g.mask, scal);
  run_scan<RunPosOp>(PosSrc{cn, scal, g.mask},
                     PosDst{cn, scal, g.mask, ns}, n,
                     reinterpret_cast<RunPos*>(aggs), st);
  write_kernel<SB, OP><<<slot_grid, kThreads, 0, st>>>(
      table, nt, fps, sr, bidx, os, ol, cn, ns, g.mask, g.r_bits);
  cudaMemcpyAsync(table, nt, size_t(words) * 4, cudaMemcpyDeviceToDevice, st);
  QF_CHECK();
  return 0;
}

}  // namespace

extern "C" {

// keys: (n, 2) int32 [hi, lo], 8-byte aligned; table: (n_words,) int32;
// out: (n,) bool. lg_slots <= 29, 1 <= r_bits <= slot_bits - 3, lg_slots +
// r_bits <= 31, slot_bits 8, 16 or 32. mode 0: the cluster walk; 1: the
// table pass; 2: the pass or the walk, chosen on the card by choose_kernel.
// The pass takes the scratch of quotient_update less ws_keys (ws_slots (3
// n_slots,) int32, aggs, scal (8,) int64); the walk alone takes none.
int quotient_contains(const void* keys, const void* table, void* out,
                      long long n, int lg_slots, int r_bits, int slot_bits,
                      unsigned fp_salt, int mode, void* ws_slots, void* aggs,
                      long long n_aggs, void* scal, void* stream) {
  if (n <= 0) return 0;
  if (lg_slots < 0 || lg_slots > 29 || r_bits < 1 ||
      r_bits > slot_bits - 3 || lg_slots + r_bits > 31 || mode < kWalk ||
      mode > kAuto)
    return -1;
  if (mode != kWalk && (ws_slots == nullptr || scal == nullptr ||
                        n_aggs < scan_tiles(1ll << lg_slots)))
    return -1;
  const Geometry g{uint32_t((1ull << lg_slots) - 1), r_bits,
                   lg_slots + r_bits, fp_salt};
  const uint2* k = static_cast<const uint2*>(keys);
  const uint32_t* t = static_cast<const uint32_t*>(table);
  bool* o = static_cast<bool*>(out);
  int* wss = static_cast<int*>(ws_slots);
  long long* ag = static_cast<long long*>(aggs);
  unsigned long long* sc = static_cast<unsigned long long*>(scal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(SB) launch_contains<SB>(k, t, o, n, g, mode, wss, ag, sc, st)
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

// keys: (n, 2) int32 [hi, lo], or fps_in: (n,) int32 fingerprints of the
// table's p = q + r bits (keys then unused; merge and resize pass decoded
// fingerprints); valid: (n,) uint8 or null (every key valid); table:
// (n_words,) int32, rebuilt in place; new_table: (n_words,) int32 scratch;
// flags: (n,) bool (ok for add, found for remove); op: 0 add, 1 remove.
// Scratch: ws_slots (5 n_slots,) int32, ws_keys (2 n,) int32, aggs
// (n_aggs,) int64 with n_aggs >= ceil(max(n_slots, n) / 4096), scal (8,)
// int64.
int quotient_update(const void* keys, const void* fps_in, const void* valid,
                    void* table, void* new_table, void* flags, long long n,
                    int lg_slots,
                    int r_bits, int slot_bits, unsigned fp_salt, int op,
                    void* ws_slots, void* ws_keys, void* aggs,
                    long long n_aggs, void* scal, void* stream) {
  if (n <= 0) return 0;
  if (lg_slots < 0 || lg_slots > 29 || r_bits < 1 ||
      r_bits > slot_bits - 3 || lg_slots + r_bits > 31 ||
      n >= (1ll << 31) || (op != kAdd && op != kRemove))
    return -1;
  const long long slots = 1ll << lg_slots;
  if (n_aggs < scan_tiles(slots > n ? slots : n)) return -1;
  const Geometry g{uint32_t(slots - 1), r_bits, lg_slots + r_bits, fp_salt};
  const uint2* k = static_cast<const uint2*>(keys);
  const uint32_t* fi = static_cast<const uint32_t*>(fps_in);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  uint32_t* t = static_cast<uint32_t*>(table);
  uint32_t* nt = static_cast<uint32_t*>(new_table);
  bool* fl = static_cast<bool*>(flags);
  int* wss = static_cast<int*>(ws_slots);
  int* wsk = static_cast<int*>(ws_keys);
  long long* ag = static_cast<long long*>(aggs);
  unsigned long long* sc = static_cast<unsigned long long*>(scal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(SB)                                                             \
  (op == kAdd ? launch_update<SB, kAdd>(k, fi, v, t, nt, fl, n, g, wss, wsk,  \
                                        ag, sc, st)                          \
              : launch_update<SB, kRemove>(k, fi, v, t, nt, fl, n, g, wss,    \
                                           wsk, ag, sc, st))
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

// The stored fingerprints of `table`: fps (n_slots,) int32 and valid
// (n_slots,) uint8, slot s holding the fingerprint stored there (0 and
// invalid for an empty slot); scratch as for the contains' table pass.
int quotient_decode(const void* table, void* fps, void* valid, int lg_slots,
                    int r_bits, int slot_bits, void* ws_slots, void* aggs,
                    long long n_aggs, void* scal, void* stream) {
  if (lg_slots < 0 || lg_slots > 29 || r_bits < 1 ||
      r_bits > slot_bits - 3 || lg_slots + r_bits > 31 ||
      n_aggs < scan_tiles(1ll << lg_slots))
    return -1;
  const Geometry g{uint32_t((1ull << lg_slots) - 1), r_bits,
                   lg_slots + r_bits, 0u};
  const uint32_t* t = static_cast<const uint32_t*>(table);
  uint32_t* f = static_cast<uint32_t*>(fps);
  uint8_t* v = static_cast<uint8_t*>(valid);
  int* wss = static_cast<int*>(ws_slots);
  long long* ag = static_cast<long long*>(aggs);
  unsigned long long* sc = static_cast<unsigned long long*>(scal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (slot_bits) {
    case 8:
      return launch_decode_fingerprints<8>(t, f, v, g, wss, ag, sc, st);
    case 16:
      return launch_decode_fingerprints<16>(t, f, v, g, wss, ag, sc, st);
    case 32:
      return launch_decode_fingerprints<32>(t, f, v, g, wss, ag, sc, st);
  }
  return -1;
}

}  // extern "C"
