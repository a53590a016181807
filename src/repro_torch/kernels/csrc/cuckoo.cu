// Cuckoo fingerprint filter kernels for Hopper (sm_90a): bulk contains and
// the ordered bulk insert / remove.
//
// Replaces the Pallas entry points of repro/kernels/cuckoofilter.py:
//   cuckoo_contains_kernel<SB, SPB>    <- contains_vmem (_contains_kernel,
//                          which runs core/fingerprint.py cuckoo_contains or
//                          cuckoo_contains_coop)
//   cuckoo_update_kernel<SB, SPB, OP>  <- add_vmem and remove_vmem
//                          (_update_vmem, _update_kernel, which run
//                          cuckoo_insert_tile / cuckoo_remove_tile)
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
//   reads a key, from L2 or DRAM.
// * cuckoo_update_kernel: the words depend on the order of the inserts
//   (which slot is free, which victim a kick evicts), and the reference
//   order is sequential: tiles of `tile` keys over the unpadded batch, each
//   stably sorted by primary bucket, applied key by key. A parallel CAS
//   cuckoo gives another table. So one CTA walks the tiles in order. For
//   each tile its threads hash the keys into shared memory and sort the
//   (b1 << 32 | index) pairs with a bitonic sort (the pairs are unique, so
//   any correct sort is the stable order by b1), then thread 0 applies the
//   keys in that order on the table in global memory, exactly as
//   _insert_one / _remove_one: the first free slot of b1, else of the
//   alternate bucket, else up to 64 kicks, each evicting lane r >> (32 -
//   log2 SPB) of the current bucket and moving the victim to its own
//   alternate bucket, r = r * 747796405 + 2891336453 after each kick; a
//   remove clears the first slot holding fp, primary bucket first. Invalid
//   slots are no-ops that report true. Flags go to the key's original
//   index. Bound: the chain of dependent bucket accesses (one thread, each
//   access an L2 or DRAM round trip); the sort and hashes are the small
//   part. A faster build that keeps the order is later work.
//
// * chase_kernel: not a port of a TPU kernel but the latency probe behind
//   the update's bound: one thread follows a chain of dependent loads
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
constexpr int kUpdateThreads = 1024;
constexpr int kMaxTile = 8192;

enum Op : int { kAdd = 0, kRemove = 1 };

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

// --- the sequential apply (thread 0 only; the table is read and written
// by this one thread, so its own program order makes every write visible
// to its later reads) --------------------------------------------------------

template <int SB, int SPB>
__device__ __forceinline__ void read_bucket(const uint32_t* t, uint32_t b,
                                            uint32_t* w) {
  const uint32_t* p = t + uint64_t(b) * Bucket<SB, SPB>::S;
#pragma unroll
  for (int c = 0; c < Bucket<SB, SPB>::S; ++c) w[c] = p[c];
}

template <int SB, int SPB>
__device__ __forceinline__ bool try_place(uint32_t* t, uint32_t b,
                                          uint32_t fp) {
  using Bk = Bucket<SB, SPB>;
  uint32_t w[Bk::S];
  read_bucket<SB, SPB>(t, b, w);
#pragma unroll
  for (int j = 0; j < SPB; ++j) {
    if (Bk::lane(w, j) == 0u) {
      Bk::set_lane(w, j, fp);
      t[uint64_t(b) * Bk::S + j / Bk::SPW] = w[j / Bk::SPW];
      return true;
    }
  }
  return false;
}

template <int SB, int SPB>
__device__ bool insert_one(uint32_t* t, const Geometry& g, uint32_t b1,
                           uint32_t fp, uint32_t r) {
  using Bk = Bucket<SB, SPB>;
  constexpr int lg_spb = log2_of(SPB);
  bool placed = try_place<SB, SPB>(t, b1, fp);
  uint32_t b = alt_bucket(g, b1, fp);
  if (!placed) placed = try_place<SB, SPB>(t, b, fp);
  uint32_t f = fp;
  for (int kicks = 0; !placed && kicks < kMaxKicks; ++kicks) {
    uint32_t w[Bk::S];
    read_bucket<SB, SPB>(t, b, w);
    const int v = lg_spb == 0 ? 0 : int(r >> (32 - lg_spb));
    const uint32_t victim = Bk::lane(w, v);
    Bk::set_lane(w, v, f);
    t[uint64_t(b) * Bk::S + v / Bk::SPW] = w[v / Bk::SPW];
    f = victim;
    b = alt_bucket(g, b, f);
    placed = try_place<SB, SPB>(t, b, f);
    r = r * kLcgMul + kLcgAdd;
  }
  return placed;
}

template <int SB, int SPB>
__device__ bool remove_one(uint32_t* t, const Geometry& g, uint32_t b1,
                           uint32_t fp) {
  using Bk = Bucket<SB, SPB>;
  uint32_t b = b1;
  for (int pass = 0; pass < 2; ++pass) {
    uint32_t w[Bk::S];
    read_bucket<SB, SPB>(t, b, w);
#pragma unroll
    for (int j = 0; j < SPB; ++j) {
      if (Bk::lane(w, j) == fp) {
        Bk::set_lane(w, j, 0u);
        t[uint64_t(b) * Bk::S + j / Bk::SPW] = w[j / Bk::SPW];
        return true;
      }
    }
    b = alt_bucket(g, b1, fp);
  }
  return false;
}

template <int SB, int SPB, int OP>
__global__ void __launch_bounds__(kUpdateThreads)
    cuckoo_update_kernel(const uint2* __restrict__ keys,
                         const uint8_t* __restrict__ valid, uint32_t* table,
                         bool* __restrict__ flags, int64_t n, int tile,
                         int sort_len, Geometry g) {
  extern __shared__ uint64_t sort_keys[];           // sort_len pairs
  uint32_t* fps = reinterpret_cast<uint32_t*>(sort_keys + sort_len);
  uint32_t* rngs = fps + tile;
  uint8_t* oks = reinterpret_cast<uint8_t*>(rngs + tile);
  for (int64_t start = 0; start < n; start += tile) {
    const int len = int(n - start < tile ? n - start : tile);
    // 1. hash the tile into shared memory
    for (int i = threadIdx.x; i < sort_len; i += blockDim.x) {
      if (i < len) {
        uint32_t h1, h2;
        hash_key(keys[start + i], h1, h2);
        fps[i] = fingerprint<SB>(h1, g.fp_salt);
        rngs[i] = h1 ^ kSeedAux;
        oks[i] = valid == nullptr ? 1 : valid[start + i];
        sort_keys[i] = (uint64_t(h2 & g.bucket_mask) << 32) | uint32_t(i);
      } else {
        sort_keys[i] = ~0ull;                       // sorts last
      }
    }
    __syncthreads();
    // 2. bitonic sort of the (b1, index) pairs
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
    // 3. one thread applies the tile in sorted order
    if (threadIdx.x == 0) {
      for (int j = 0; j < len; ++j) {
        const uint64_t pair = sort_keys[j];
        const int idx = int(uint32_t(pair));
        const uint32_t b1 = uint32_t(pair >> 32);
        bool ok = true;
        if (oks[idx]) {
          ok = OP == kAdd ? insert_one<SB, SPB>(table, g, b1, fps[idx],
                                                rngs[idx])
                          : remove_one<SB, SPB>(table, g, b1, fps[idx]);
        }
        flags[start + idx] = ok;
      }
    }
    __syncthreads();
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

template <int SB, int SPB, int OP>
int launch_update(const uint2* keys, const uint8_t* valid, uint32_t* table,
                  bool* flags, int64_t n, int tile, const Geometry& g,
                  cudaStream_t stream) {
  int sort_len = 1;
  while (sort_len < tile) sort_len <<= 1;
  const size_t bytes = size_t(sort_len) * sizeof(uint64_t) +
                       size_t(tile) * (2 * sizeof(uint32_t) + 1);
  if (bytes > 48 * 1024 &&
      cudaFuncSetAttribute(cuckoo_update_kernel<SB, SPB, OP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(bytes)) != cudaSuccess)
    return int(cudaGetLastError());
  cuckoo_update_kernel<SB, SPB, OP><<<1, kUpdateThreads, bytes, stream>>>(
      keys, valid, table, flags, n, tile, sort_len, g);
  return int(cudaGetLastError());
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
// flags: (n,) bool (ok for add, found for remove); tile in [1, 8192];
// op: 0 add, 1 remove.
int cuckoo_update(const void* keys, const void* valid, void* table,
                  void* flags, long long n, int tile, unsigned bucket_mask,
                  int lg_buckets, int slot_bits, int spb, unsigned fp_salt,
                  unsigned alt_salt, int op, void* stream) {
  if (n <= 0) return 0;
  if (tile < 1 || tile > kMaxTile || (op != kAdd && op != kRemove))
    return -1;
  const Geometry g{bucket_mask, lg_buckets, fp_salt, alt_salt};
  const uint2* k = static_cast<const uint2*>(keys);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  uint32_t* t = static_cast<uint32_t*>(table);
  bool* fl = static_cast<bool*>(flags);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(SB, SPB)                                            \
  (op == kAdd ? launch_update<SB, SPB, kAdd>(k, v, t, fl, n, tile, g, st) \
              : launch_update<SB, SPB, kRemove>(k, v, t, fl, n, tile, g, st))
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
