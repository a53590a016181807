// counting_contains: the counting Bloom filter's membership on counter
// occupancy for Hopper (sm_90a), both forms, built beside counting.cu in a
// parallel nvcc process (it holds most of the counting instances).
//
// Replaces, in repro/kernels/countingbf.py:
//   counting_contains_kernel<S, THETA, V, 1>     <- contains_vmem
//       (_contains_vmem_kernel, _contains_vmem_gather_kernel,
//        _contains_vmem_coop_kernel)
//   counting_contains_kernel<S, THETA, 4, DEPTH> <- contains_hbm
//       (_contains_hbm_kernel, _contains_hbm_coop_kernel)
//   counting_contains_kernel<.., true>           <- bank_contains_vmem
//       (_bank_contains_vmem_gather_kernel)
//
// Design: warp-cooperative, as the blocked contains (bloom_blocked.cuh). A
// key's counter row is 4S words (16 S bytes: 128 for B = 256), one logical
// word of its mask per aligned 16-byte group (counting.cu's header). THETA
// adjacent lanes own one key together; lane j of the group owns logical
// words [j S/THETA, (j + 1) S/THETA), that is W = 4S/THETA counter words,
// and loads them V words at a time, so a key's row leaves the warp as one
// coalesced request (S/THETA 16-byte loads a lane), not S dependent ones. A
// lane builds only its own words' nibble increments (word_incs), tests
// (nib_nonzero(w) & inc) == inc on each, and the group decides the key by a
// ballot. A lane hashes one key of the warp's 32 (P of them where DEPTH >
// THETA) and shares it by shuffle; a group keeps DEPTH keys' loads in
// flight before any test, a few words a lane each (DEPTH * W <= 32: 64
// words in flight a lane spilled and ran slower on the H100), which take
// the place of contains_hbm's DMA ring. There is no early exit: a
// member key reads its whole row in any design, and a non-member's row is
// one request whether or not its later words are read.
//
// It replaces one thread a key walking its S logical words, which waited on
// the test of word j before loading word j + 1 (S dependent round trips for
// a member) and held DEPTH x S mask words in registers (depth 8 of B = 256
// cost occupancy: 11.70 ms against 5.23 at depth 1 for 2^26 keys in 512 MiB
// on the H100). Bound: DRAM bytes in the DRAM regime (the keys, the results
// and a key's touched 32-byte sectors of its row), L2 bandwidth and integer
// issue in the L2 regime.
//
// Banks (BANK = true): key i's row starts at member[i] * member_words +
// block * 4S (64-bit offsets), so B members take one launch in either
// regime.
//
// C interface for ctypes: each entry point returns cudaGetLastError() after
// its launch, or -1 for a shape that has no instance. The wrappers check
// every member id against [0, B) before a bank launch.

#include "counting_common.cuh"

namespace {

constexpr int kWarps = kThreads / 32;
constexpr uint32_t kDeadBlock = 0xffffffffu;   // a lane past n

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

// A warp's tile is 32 * P keys; round r of the group whose first lane is
// `leader` takes key slot p = r / THETA of lane leader + r % THETA, so each
// key of the tile is taken by one group in one round, and lane r % THETA
// of the group owns its result (bloom_contains_kernel's map).
template <int S, int THETA, int V, int DEPTH, bool BANK>
__global__ void __launch_bounds__(kThreads)
    counting_contains_kernel(const uint2* __restrict__ keys,
                             const int32_t* __restrict__ member,
                             const uint32_t* __restrict__ counters,
                             bool* __restrict__ out,
                             const uint32_t* __restrict__ salts, int64_t n,
                             uint64_t member_words, uint32_t block_mask,
                             int k) {
  constexpr int WL = S / THETA;                     // logical words a lane
  constexpr int W = 4 * WL;                         // counter words a lane
  constexpr int P = DEPTH > THETA ? DEPTH / THETA : 1;
  constexpr int BATCHES = THETA * P / DEPTH;        // DEPTH rounds a batch
  static_assert(32 % THETA == 0 && S % THETA == 0, "THETA divides 32 and S");
  static_assert(V == 1 || V == 2 || V == 4, "V divides 4");
  static_assert(DEPTH * W <= 32, "at most 32 words in flight a lane");
  __shared__ uint32_t salt[kMaxSalts];
  for (int i = threadIdx.x; i < kMaxSalts; i += blockDim.x) salt[i] = salts[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int j = lane % THETA;                       // place in the group
  const int leader = lane - j;
  const int64_t tile =
      (int64_t(blockIdx.x) * kWarps + threadIdx.x / 32) * (32 * P);
  if (tile >= n) return;                            // the whole warp leaves

  uint32_t h_pat[P], blk[P], mem[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int64_t i = tile + p * 32 + lane;
    h_pat[p] = 0u;
    blk[p] = kDeadBlock;
    mem[p] = 0u;
    if (i < n) {
      uint32_t h_blk;
      hash_key(keys[i], h_pat[p], h_blk);
      blk[p] = h_blk & block_mask;
      if constexpr (BANK) mem[p] = uint32_t(member[i]);
    }
  }
  bool hit[P];
#pragma unroll
  for (int p = 0; p < P; ++p) hit[p] = false;

  // one batch: DEPTH rounds, every load issued before any test
  auto batch = [&](int b) {
    uint32_t hk[DEPTH];
    uint32_t w[DEPTH][W];
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      const int r = b * DEPTH + d;
      const int p = P == 1 ? 0 : r / THETA;
      const int src = leader + r % THETA;
      hk[d] = __shfl_sync(kFullWarp, h_pat[p], src);
      const uint32_t bk = __shfl_sync(kFullWarp, blk[p], src);
      uint32_t mk = 0u;
      if constexpr (BANK) mk = __shfl_sync(kFullWarp, mem[p], src);
      const uint32_t* base =
          counters + counter_row<S, BANK>(bk, mk, member_words) + j * W;
#pragma unroll
      for (int c = 0; c < W / V; ++c) {
        if (bk != kDeadBlock) {
          Vec<V>::load(base + c * V, &w[d][c * V]);
        } else {
#pragma unroll
          for (int t = 0; t < V; ++t) w[d][c * V + t] = 0u;
        }
      }
    }
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      const int r = b * DEPTH + d;
      const int p = P == 1 ? 0 : r / THETA;
      uint32_t miss = 0u;
#pragma unroll
      for (int q = 0; q < WL; ++q) {
        uint32_t inc[4];
        word_incs<S>(hk[d], j * WL + q, salt, k, inc);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          miss |= inc[c] & ~nib_nonzero(w[d][4 * q + c]);
      }
      constexpr unsigned kGroup =
          THETA == 32 ? kFullWarp : (1u << THETA) - 1u;
      const unsigned missed = __ballot_sync(kFullWarp, miss != 0u);
      if (j == r % THETA) hit[p] = ((missed >> leader) & kGroup) == 0u;
    }
  };
  if constexpr (BATCHES == 1) {
    batch(0);
  } else {
    for (int b = 0; b < BATCHES; ++b) batch(b);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int64_t i = tile + p * 32 + lane;
    if (i < n) out[i] = hit[p];
  }
}

template <int S, int THETA, int V, int DEPTH, bool BANK>
int launch_contains(const ContainsArgs& a, cudaStream_t stream) {
  constexpr int64_t per_cta =
      int64_t(kThreads) * (DEPTH > THETA ? DEPTH / THETA : 1);
  const unsigned grid = unsigned((a.n + per_cta - 1) / per_cta);
  counting_contains_kernel<S, THETA, V, DEPTH, BANK>
      <<<grid, kThreads, 0, stream>>>(a.keys, a.member, a.counters, a.out,
                                      a.salts, a.n, a.member_words,
                                      a.block_mask, a.k);
  return int(cudaGetLastError());
}

// Depth 1 runs every load width V (the single form; the bank form loads
// 16 bytes); a deeper schedule runs V = 4 with at most 32 words in flight a
// lane.
template <int S, int THETA, int V, bool BANK>
int dispatch_depth(int depth, const ContainsArgs& a, cudaStream_t st) {
  constexpr int W = 4 * S / THETA;
  if (depth > 1 && V != 4) return -1;
  switch (depth) {
    case 1:
      return launch_contains<S, THETA, V, 1, BANK>(a, st);
    case 2:
      if constexpr (V == 4 && 2 * W <= 32)
        return launch_contains<S, THETA, V, 2, BANK>(a, st);
      break;
    case 4:
      if constexpr (V == 4 && 4 * W <= 32)
        return launch_contains<S, THETA, V, 4, BANK>(a, st);
      break;
    case 8:
      if constexpr (V == 4 && 8 * W <= 32)
        return launch_contains<S, THETA, V, 8, BANK>(a, st);
      break;
  }
  return -1;
}

template <int S, int THETA, bool BANK>
int dispatch_vec(int vec, int depth, const ContainsArgs& a,
                 cudaStream_t st) {
  switch (vec) {
    case 1:
      if constexpr (!BANK) return dispatch_depth<S, THETA, 1, BANK>(depth, a,
                                                                    st);
      break;
    case 2:
      if constexpr (!BANK) return dispatch_depth<S, THETA, 2, BANK>(depth, a,
                                                                    st);
      break;
    case 4:
      return dispatch_depth<S, THETA, 4, BANK>(depth, a, st);
  }
  return -1;
}

// Theta in 1 ... S with at most 32 counter words a lane (theta >= S / 8).
template <int S, int THETA, bool BANK>
int dispatch_lanes(int vec, int depth, const ContainsArgs& a,
                   cudaStream_t st) {
  if constexpr (THETA <= S && 4 * S / THETA <= 32)
    return dispatch_vec<S, THETA, BANK>(vec, depth, a, st);
  return -1;
}

template <int S, bool BANK>
int dispatch_theta(int theta, int vec, int depth, const ContainsArgs& a,
                   cudaStream_t st) {
  switch (theta) {
    case 1:
      return dispatch_lanes<S, 1, BANK>(vec, depth, a, st);
    case 2:
      return dispatch_lanes<S, 2, BANK>(vec, depth, a, st);
    case 4:
      return dispatch_lanes<S, 4, BANK>(vec, depth, a, st);
    case 8:
      return dispatch_lanes<S, 8, BANK>(vec, depth, a, st);
    case 16:
      return dispatch_lanes<S, 16, BANK>(vec, depth, a, st);
    case 32:
      return dispatch_lanes<S, 32, BANK>(vec, depth, a, st);
  }
  return -1;
}

template <bool BANK>
int contains_entry(int s, int theta, int vec, int depth,
                   const ContainsArgs& a, cudaStream_t st) {
  switch (s) {
    case 1:
      return dispatch_theta<1, BANK>(theta, vec, depth, a, st);
    case 2:
      return dispatch_theta<2, BANK>(theta, vec, depth, a, st);
    case 4:
      return dispatch_theta<4, BANK>(theta, vec, depth, a, st);
    case 8:
      return dispatch_theta<8, BANK>(theta, vec, depth, a, st);
    case 16:
      return dispatch_theta<16, BANK>(theta, vec, depth, a, st);
    case 32:
      return dispatch_theta<32, BANK>(theta, vec, depth, a, st);
  }
  return -1;
}

}  // namespace

extern "C" {

// keys: (n, 2) int32 [hi, lo], 8-byte aligned; member: (n,) int32 in
// [0, B), or null for one filter; counters: one filter's (storage_words,)
// or the (B, member_words) bank, int32, 16-byte aligned; out: (n,) bool;
// salts: (3, 96) int32. theta: lanes a key (s / 8 ... s); vec: words a load
// (1, 2, 4; a bank and a depth past 1 take 4); depth: keys a group keeps
// in flight (1, 2, 4, 8, with depth * 4s / theta <= 32)
// (countingbf.contains_geometry).
int counting_contains(const void* keys, const void* member,
                      const void* counters, void* out, const void* salts,
                      long long n, unsigned long long member_words,
                      unsigned block_mask, int s, int theta, int vec,
                      int depth, int k, void* stream) {
  if (n == 0) return 0;
  const ContainsArgs a{static_cast<const uint2*>(keys),
                       static_cast<const int32_t*>(member),
                       static_cast<const uint32_t*>(counters),
                       static_cast<bool*>(out),
                       static_cast<const uint32_t*>(salts), n, member_words,
                       block_mask, k};
  const auto st = static_cast<cudaStream_t>(stream);
  return member != nullptr ? contains_entry<true>(s, theta, vec, depth, a, st)
                           : contains_entry<false>(s, theta, vec, depth, a,
                                                   st);
}

}  // extern "C"
