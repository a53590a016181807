// The warp-cooperative blocked Bloom kernels, bloom_add_kernel and
// bloom_contains_kernel, with their host-side dispatch over the template
// parameters. bloom.cu's header comment sets out the design; this header
// lets three libraries instantiate them in parallel builds: bloom.cu (the
// add, both forms), bloom_contains.cu and bloom_bank_contains.cu (the two
// forms of the contains, the bulk of the instances).

#pragma once

#include "bloom_common.cuh"

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kWarps = kThreads / 32;
// The block of a lane that holds no key (past n, or an invalid slot): a
// block index is below 2^31 (the wrappers keep n_words below 2^31).
constexpr uint32_t kDeadBlock = 0xffffffffu;

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

// First word of a block row: block * S, plus a bank member's offset (64-bit).
template <int S, bool BANK>
__device__ __forceinline__ uint64_t row_of(uint32_t block, uint32_t mem,
                                           uint64_t member_words) {
  uint64_t start = uint64_t(block) * uint64_t(S);
  if constexpr (BANK) start += uint64_t(mem) * member_words;
  return start;
}

// Hash key i (if below n) into its pattern hash, its block (kDeadBlock
// past n) and, for a bank, its member.
template <bool BANK>
__device__ __forceinline__ void key_of(const uint2* keys,
                                       const int32_t* member, int64_t i,
                                       int64_t n, uint32_t block_mask,
                                       uint32_t& h_pat, uint32_t& block,
                                       uint32_t& mem) {
  h_pat = 0u;
  block = kDeadBlock;
  mem = 0u;
  if (i < n) {
    uint32_t h_blk;
    hash_key(keys[i], h_pat, h_blk);
    block = h_blk & block_mask;
    if constexpr (BANK) mem = uint32_t(member[i]);
  }
}

// A warp's tile is 32 * P keys (P = DEPTH / THETA keys a lane where a group
// keeps more keys in flight than it has lanes, else 1): lane l owns keys
// tile + p * 32 + l. Round r of the group whose first lane is `leader`
// takes key slot p = r / THETA of lane leader + r % THETA, so every key of
// the tile is taken by exactly one group in exactly one round, and the
// lane that owns a key is lane j = r % THETA of its group. THETA = 1 is one
// thread a key, the first design's kernel as it was: thread t of a CTA
// takes keys base + d * kThreads, hashes and loads all DEPTH of them, then
// tests them key by key with the whole mask, leaving a key at its first
// load that misses.
template <int S, int THETA, int V, int DEPTH, bool BANK>
__global__ void __launch_bounds__(kThreads)
    bloom_contains_kernel(const uint2* __restrict__ keys,
                          const int32_t* __restrict__ member,
                          const uint32_t* __restrict__ words,
                          bool* __restrict__ out,
                          const uint32_t* __restrict__ salts, int64_t n,
                          uint64_t member_words, uint32_t block_mask,
                          int variant, int k, int z, int log2g) {
  constexpr int W = S / THETA;                      // words a lane owns
  constexpr int P = DEPTH > THETA ? DEPTH / THETA : 1;
  constexpr int BATCHES = THETA * P / DEPTH;        // DEPTH rounds a batch
  static_assert(32 % THETA == 0 && S % THETA == 0, "THETA divides 32 and S");
  static_assert(W % V == 0 && V <= 4, "V divides a lane's words");
  static_assert(DEPTH * W <= 64, "at most 64 words in flight a lane");
  __shared__ uint32_t smem[3 * kMaxSalts];
  stage_salts(smem, salts);

  if constexpr (THETA == 1) {       // the first design; no collective
    const int64_t base =
        int64_t(blockIdx.x) * (kThreads * DEPTH) + threadIdx.x;
    uint32_t hk[DEPTH];
    uint32_t w[DEPTH][S];
    // hash every key and issue every block load
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      const int64_t i = base + int64_t(d) * kThreads;
      const bool live = i < n;
      uint32_t h_blk = 0u;
      hk[d] = 0u;
      if (live) hash_key(keys[i], hk[d], h_blk);
      uint64_t start = uint64_t(h_blk & block_mask) * uint64_t(S);
      if constexpr (BANK) {
        if (live) start += uint64_t(uint32_t(member[i])) * member_words;
      }
      const uint32_t* row = words + start;
#pragma unroll
      for (int c = 0; c < S / V; ++c) {
        if (live) {
          Vec<V>::load(row + c * V, &w[d][c * V]);
        } else {
#pragma unroll
          for (int t = 0; t < V; ++t) w[d][c * V + t] = 0u;
        }
      }
    }
    // masks and the early-exit test, key by key
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      const int64_t i = base + int64_t(d) * kThreads;
      if (i >= n) break;
      uint32_t m[S];
      build_mask<S>(m, hk[d], smem, smem + kMaxSalts, smem + 2 * kMaxSalts,
                    variant, k, z, log2g);
      bool ok = true;
#pragma unroll
      for (int c = 0; c < S / V; ++c) {
        uint32_t miss = 0u;
#pragma unroll
        for (int t = 0; t < V; ++t) miss |= m[c * V + t] & ~w[d][c * V + t];
        if (miss) {
          ok = false;
          break;
        }
      }
      out[i] = ok;
    }
  } else {
    const int lane = threadIdx.x & 31;
    const int j = lane % THETA;                     // place in the group
    const int leader = lane - j;
    const int64_t tile =
        (int64_t(blockIdx.x) * kWarps + threadIdx.x / 32) * (32 * P);
    if (tile >= n) return;                          // the whole warp leaves

    // the lane's own keys, hashed once and shared by shuffle
    uint32_t h_pat[P], blk[P], mem[P];
#pragma unroll
    for (int p = 0; p < P; ++p)
      key_of<BANK>(keys, member, tile + p * 32 + lane, n, block_mask,
                   h_pat[p], blk[p], mem[p]);
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
        uint32_t mk = 0u;
        hk[d] = __shfl_sync(kFullWarp, h_pat[p], src);
        const uint32_t bk = __shfl_sync(kFullWarp, blk[p], src);
        if constexpr (BANK) mk = __shfl_sync(kFullWarp, mem[p], src);
        const uint32_t* base =
            words + row_of<S, BANK>(bk, mk, member_words) + j * W;
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
        uint32_t m[W];
        build_mask_part<S, W>(m, hk[d], j * W, smem, smem + kMaxSalts,
                              smem + 2 * kMaxSalts, variant, k, z, log2g);
        uint32_t miss = 0u;
#pragma unroll
        for (int t = 0; t < W; ++t) miss |= m[t] & ~w[d][t];
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
}

template <int S, int THETA, bool BANK>
__global__ void __launch_bounds__(kThreads)
    bloom_add_kernel(const uint2* __restrict__ keys,
                     const int32_t* __restrict__ member,
                     const uint8_t* __restrict__ valid, uint32_t* words,
                     const uint32_t* __restrict__ salts, int64_t n,
                     uint64_t member_words, uint32_t block_mask, int variant,
                     int k, int z, int log2g) {
  constexpr int W = S / THETA;                      // words a lane owns
  static_assert(32 % THETA == 0 && S % THETA == 0, "THETA divides 32 and S");
  __shared__ uint32_t smem[3 * kMaxSalts];
  stage_salts(smem, salts);
  const int lane = threadIdx.x & 31;
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if constexpr (THETA == 1) {       // one thread a key; no collective below
    if (i >= n || (valid != nullptr && valid[i] == 0)) return;
    uint32_t h_pat, h_blk;
    hash_key(keys[i], h_pat, h_blk);
    uint32_t m[S];
    build_mask<S>(m, h_pat, smem, smem + kMaxSalts, smem + 2 * kMaxSalts,
                  variant, k, z, log2g);
    uint32_t* dst = words + row_of<S, BANK>(h_blk & block_mask,
                                            BANK ? uint32_t(member[i]) : 0u,
                                            member_words);
#pragma unroll
    for (int t = 0; t < S; ++t)
      if (m[t]) atomicOr(dst + t, m[t]);
  } else {
    if (i - lane >= n) return;                      // the whole warp leaves
    uint32_t h_pat, blk, mem;
    key_of<BANK>(keys, member, i, n, block_mask, h_pat, blk, mem);
    if (valid != nullptr && i < n && valid[i] == 0) blk = kDeadBlock;
    const int j = lane % THETA;
    const int leader = lane - j;
    for (int r = 0; r < THETA; ++r) {
      const int src = leader + r;
      const uint32_t hk = __shfl_sync(kFullWarp, h_pat, src);
      const uint32_t bk = __shfl_sync(kFullWarp, blk, src);
      uint32_t mk = 0u;
      if constexpr (BANK) mk = __shfl_sync(kFullWarp, mem, src);
      if (bk != kDeadBlock) {
        uint32_t m[W];
        build_mask_part<S, W>(m, hk, j * W, smem, smem + kMaxSalts,
                              smem + 2 * kMaxSalts, variant, k, z, log2g);
        uint32_t* dst =
            words + row_of<S, BANK>(bk, mk, member_words) + j * W;
#pragma unroll
        for (int t = 0; t < W; ++t)
          if (m[t]) atomicOr(dst + t, m[t]);
      }
    }
  }
}

// Keys a CTA takes: 32 * P a warp (P keys a lane where DEPTH > THETA).
template <int THETA, int DEPTH>
constexpr int64_t contains_keys_per_cta() {
  return int64_t(kThreads) * (DEPTH > THETA ? DEPTH / THETA : 1);
}

template <int S, int THETA, int V, int DEPTH, bool BANK>
int launch_contains(const ContainsArgs& a, unsigned grid,
                    cudaStream_t stream) {
  if (int64_t(grid) * contains_keys_per_cta<THETA, DEPTH>() < a.n) return -1;
  bloom_contains_kernel<S, THETA, V, DEPTH, BANK>
      <<<grid, kThreads, 0, stream>>>(a.keys, a.member, a.words, a.out,
                                      a.salts, a.n, a.member_words,
                                      a.block_mask, a.variant, a.k, a.z,
                                      a.log2g);
  return int(cudaGetLastError());
}

// Depth 1 runs every load width V; a deeper schedule runs the widest
// (min(W, 4)) with at most 64 words in flight a lane.
template <int S, int THETA, int V, bool BANK>
int dispatch_depth(int depth, const ContainsArgs& a, unsigned grid,
                   cudaStream_t st) {
  constexpr int W = S / THETA;
  constexpr bool kDeep = V == (W < 4 ? W : 4);
  if (depth > 1 && !kDeep) return -1;
  switch (depth) {
    case 1:
      return launch_contains<S, THETA, V, 1, BANK>(a, grid, st);
    case 2:
      if constexpr (kDeep && 2 * W <= 64)
        return launch_contains<S, THETA, V, 2, BANK>(a, grid, st);
      break;
    case 4:
      if constexpr (kDeep && 4 * W <= 64)
        return launch_contains<S, THETA, V, 4, BANK>(a, grid, st);
      break;
    case 8:
      if constexpr (kDeep && 8 * W <= 64)
        return launch_contains<S, THETA, V, 8, BANK>(a, grid, st);
      break;
  }
  return -1;
}

template <int S, int THETA, bool BANK>
int dispatch_vec(int vec, int depth, const ContainsArgs& a, unsigned grid,
                 cudaStream_t st) {
  constexpr int W = S / THETA;
  switch (vec) {
    case 1:
      return dispatch_depth<S, THETA, 1, BANK>(depth, a, grid, st);
    case 2:
      if constexpr (W >= 2)
        return dispatch_depth<S, THETA, 2, BANK>(depth, a, grid, st);
      break;
    case 4:
      if constexpr (W >= 4)
        return dispatch_depth<S, THETA, 4, BANK>(depth, a, grid, st);
      break;
  }
  return -1;
}

template <int S, bool BANK>
int dispatch_theta(int theta, int vec, int depth, const ContainsArgs& a,
                   unsigned grid, cudaStream_t st) {
  switch (theta) {
    case 1:
      return dispatch_vec<S, 1, BANK>(vec, depth, a, grid, st);
    case 2:
      if constexpr (S >= 2)
        return dispatch_vec<S, 2, BANK>(vec, depth, a, grid, st);
      break;
    case 4:
      if constexpr (S >= 4)
        return dispatch_vec<S, 4, BANK>(vec, depth, a, grid, st);
      break;
    case 8:
      if constexpr (S >= 8)
        return dispatch_vec<S, 8, BANK>(vec, depth, a, grid, st);
      break;
    case 16:
      if constexpr (S >= 16)
        return dispatch_vec<S, 16, BANK>(vec, depth, a, grid, st);
      break;
    case 32:
      if constexpr (S >= 32)
        return dispatch_vec<S, 32, BANK>(vec, depth, a, grid, st);
      break;
  }
  return -1;
}

template <bool BANK>
int contains_entry(int s, int theta, int vec, int depth, unsigned grid,
                   const ContainsArgs& a, cudaStream_t st) {
  switch (s) {
    case 1:
      return dispatch_theta<1, BANK>(theta, vec, depth, a, grid, st);
    case 2:
      return dispatch_theta<2, BANK>(theta, vec, depth, a, grid, st);
    case 4:
      return dispatch_theta<4, BANK>(theta, vec, depth, a, grid, st);
    case 8:
      return dispatch_theta<8, BANK>(theta, vec, depth, a, grid, st);
    case 16:
      return dispatch_theta<16, BANK>(theta, vec, depth, a, grid, st);
    case 32:
      return dispatch_theta<32, BANK>(theta, vec, depth, a, grid, st);
  }
  return -1;
}

template <int S, int THETA, bool BANK>
int launch_add(const AddArgs& a, unsigned grid, cudaStream_t stream) {
  if (int64_t(grid) * kThreads < a.n) return -1;
  bloom_add_kernel<S, THETA, BANK><<<grid, kThreads, 0, stream>>>(
      a.keys, a.member, a.valid, a.words, a.salts, a.n, a.member_words,
      a.block_mask, a.variant, a.k, a.z, a.log2g);
  return int(cudaGetLastError());
}

template <int S, bool BANK>
int dispatch_add_theta(int theta, const AddArgs& a, unsigned grid,
                       cudaStream_t st) {
  switch (theta) {
    case 1:
      return launch_add<S, 1, BANK>(a, grid, st);
    case 2:
      if constexpr (S >= 2) return launch_add<S, 2, BANK>(a, grid, st);
      break;
    case 4:
      if constexpr (S >= 4) return launch_add<S, 4, BANK>(a, grid, st);
      break;
    case 8:
      if constexpr (S >= 8) return launch_add<S, 8, BANK>(a, grid, st);
      break;
    case 16:
      if constexpr (S >= 16) return launch_add<S, 16, BANK>(a, grid, st);
      break;
    case 32:
      if constexpr (S >= 32) return launch_add<S, 32, BANK>(a, grid, st);
      break;
  }
  return -1;
}

template <bool BANK>
int add_entry(int s, int theta, unsigned grid, const AddArgs& a,
              cudaStream_t st) {
  switch (s) {
    case 1:
      return dispatch_add_theta<1, BANK>(theta, a, grid, st);
    case 2:
      return dispatch_add_theta<2, BANK>(theta, a, grid, st);
    case 4:
      return dispatch_add_theta<4, BANK>(theta, a, grid, st);
    case 8:
      return dispatch_add_theta<8, BANK>(theta, a, grid, st);
    case 16:
      return dispatch_add_theta<16, BANK>(theta, a, grid, st);
    case 32:
      return dispatch_add_theta<32, BANK>(theta, a, grid, st);
  }
  return -1;
}

}  // namespace
