// Generation-ring membership kernels for Hopper (sm_90a): bulk contains
// against a windowed filter's (G, n_words) ring of same-spec generations,
// for the sbf / bbf / rbbf / csbf variants.
//
// Replaces the two Pallas entry points of repro/kernels/ring.py:
//   ring_contains_kernel<S, THETA, V> <- ring_contains_vmem
//                                        (_ring_vmem_kernel) and
//                                        ring_contains_hbm (_ring_hbm_kernel)
// and, for both, where kernels/ring.py choose_contains_path picks it, the
// binned contains: ring_bin_count_kernel, bin_column_kernel,
// bin_scan_kernel (bin_common.cuh), ring_bin_scatter_kernel,
// ring_bin_test_kernel<S>.
//
// A key is in the window iff its mask is covered by the OR of its block row
// over the G generations: contains(OR of the generations), computed without
// materialising the O(m) union. Generation g's words start at g * n_words
// (64-bit offsets); G is a runtime value (any G >= 1).
//
// * ring_contains_kernel<S, THETA, V> (one pass): the blocked contains'
//   warp cooperation (bloom_blocked.cuh bloom_contains_kernel): a group of
//   THETA lanes owns one key, lane j owning the W = S / THETA words
//   [j * W, (j + 1) * W) of its row, loaded V words at a time; a lane
//   hashes one key of the warp's 32 and shares it by shuffle, and the
//   groups take their lanes' keys in THETA rounds. A group reads the key's
//   row generation by generation, from the last down, ORs it in and ends
//   the key once a __ballot_sync finds the OR covers its mask (exact: the
//   OR only grows). A member of a generation reads the rows down to its
//   generation's, (G + 1) / 2 of them on average where members spread over
//   the generations; a key that is not a member reads all G. The warp's
//   groups step together until none has a key left open. Each row of
//   B = 256 bits is one 32-byte sector, read whole by one instruction
//   (THETA = 2 lanes of 16 bytes); the first design read 16 bytes of the
//   row from every generation, tested them and then read the other 16, so
//   a sector cost two requests and a member a second round trip. The
//   schedule that issued every generation's loads of several keys before
//   one test (a depth, as _ring_hbm_kernel's DMA ring) took 8.40 ms for
//   the DRAM cell's live keys against this one's 5.22 and tied it for
//   keys that are not members, so it was dropped. The kernel keeps one key
//   a group in flight; the warps an SM holds cover the round trips.
//   Bound: in DRAM, G random 32-byte sectors a key for B = 256 (the rows
//   of G generations lie n_words apart); in L2, L2 requests and integer
//   issue.
// * The binned contains (ring_contains_binned), for a ring in DRAM and a
//   large batch: any one-pass schedule reads G random sectors a key (2^28
//   sectors for 2^26 keys at G = 4), so it runs at DRAM's random-sector
//   rate. Binning reads each row once a batch, coalesced. Per internal batch
//   of at most `batch` keys, five kernels on the caller's stream, the
//   stages of the binned cbf contains (cbf.cu):
//   1. ring_bin_count_kernel: chunk c hashes its keys and counts them by
//      bin (2^bin_row_bits block rows, all G generations) in shared memory;
//   2. bin_column_kernel: each bin's per-chunk runs, padded to a 32-byte
//      sector (2 slots);
//   3. bin_scan_kernel: each bin's slice of the slot workspace;
//   4. ring_bin_scatter_kernel: chunk c hashes its keys again and writes a
//      16-byte slot (key index in the batch, pattern hash, row in the bin,
//      0) into its run; a bin's open sector is staged in shared memory and
//      written whole, as cbf_bin_scatter_kernel does (L2 evicts sectors
//      half written); a run's last sector is padded with a filler slot;
//   5. ring_bin_test_kernel<S>: one CTA a bin reads the bin's rows of all G
//      generations coalesced (16-byte loads), ORs them into one slice in
//      shared memory, then tests each slot's mask bits against its row of
//      the slice (row_covers: each bit against its word, no mask array)
//      and stores the key's result at its index. A bin with no keys
//      is not read. A slot carries the pattern hash, so the test never
//      reads a key again (an 8-byte slot would have to: a random sector a
//      key).
//   Bound: per batch the keys read twice (count, scatter), 16 B a slot
//   written and read, the touched bins of the ring read once, the results
//   written once; a batch's results (1 B a key, stored at random) should
//   stay in L2, which caps the batch.
//
// Salts (3 x 96 u32) are staged in shared memory once per CTA; the masks
// come from bloom_common.cuh's build_mask / build_mask_part, as in bloom.cu.
//
// C interface for ctypes: each entry point returns cudaGetLastError() after
// its launches, 0 for n == 0 (nothing launched), or -1 for a shape that has
// no instantiation or a geometry the binned kernels do not take.

#include "bin_common.cuh"

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr uint32_t kDeadBlock = 0xffffffffu;
constexpr int kMaxGroupBins = 4096;      // 40 B a bin in the scatter
constexpr uint32_t kFillSlot = 0xffffffffu;

template <int S, int THETA, int V>
__global__ void __launch_bounds__(kThreads)
    ring_contains_kernel(const uint2* __restrict__ keys,
                         const uint32_t* __restrict__ rings,
                         bool* __restrict__ out,
                         const uint32_t* __restrict__ salts, int64_t n,
                         int64_t n_words, int n_gen, uint32_t block_mask,
                         int variant, int k, int z, int log2g) {
  constexpr int W = S / THETA;                      // words a lane owns
  constexpr unsigned kGroup = THETA == 32 ? kFullWarp : (1u << THETA) - 1u;
  static_assert(32 % THETA == 0 && S % THETA == 0, "THETA divides 32 and S");
  static_assert(W % V == 0 && V <= 4, "V divides a lane's words");
  __shared__ uint32_t smem[3 * kMaxSalts];
  stage_salts(smem, salts);
  const int lane = threadIdx.x & 31;
  const int j = lane % THETA;                       // place in the group
  const int leader = lane - j;
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i - lane >= n) return;                        // the whole warp leaves

  // the lane's own key, hashed once and shared by shuffle
  uint32_t h_pat = 0u, blk = kDeadBlock;
  if (i < n) {
    uint32_t h_blk;
    hash_key(keys[i], h_pat, h_blk);
    blk = h_blk & block_mask;
  }
  bool hit = false;
  // round r: each group takes the key of its lane r
  for (int r = 0; r < THETA; ++r) {
    const uint32_t hk = __shfl_sync(kFullWarp, h_pat, leader + r);
    const uint32_t bk = __shfl_sync(kFullWarp, blk, leader + r);
    const bool live = bk != kDeadBlock;
    const uint32_t* row =
        rings + uint64_t(live ? bk : 0u) * uint64_t(S) + j * W;
    uint32_t m[W], acc[W];
    build_mask_part<S, W>(m, hk, j * W, smem, smem + kMaxSalts,
                          smem + 2 * kMaxSalts, variant, k, z, log2g);
#pragma unroll
    for (int t = 0; t < W; ++t) acc[t] = 0u;
    // the generations from the last down, until the group's OR covers the
    // key's mask (the OR only grows, so the stop is exact)
    bool covered = false;
    for (int g = n_gen - 1; g >= 0; --g) {
      if (live && !covered) {
#pragma unroll
        for (int c = 0; c < W / V; ++c) {
          uint32_t v[V];
          Vec<V>::load(row + int64_t(g) * n_words + c * V, v);
#pragma unroll
          for (int t = 0; t < V; ++t) acc[c * V + t] |= v[t];
        }
      }
      uint32_t miss = 0u;
#pragma unroll
      for (int t = 0; t < W; ++t) miss |= m[t] & ~acc[t];
      const unsigned missed = __ballot_sync(kFullWarp, miss != 0u);
      covered = ((missed >> leader) & kGroup) == 0u;
      if (!__any_sync(kFullWarp, live && !covered)) break;
    }
    if (j == r) hit = covered;
  }
  if (i < n) out[i] = hit;
}

struct RingArgs {
  const uint2* keys;
  const uint32_t* rings;
  bool* out;
  const uint32_t* salts;
  int64_t n, n_words;
  int n_gen;
  uint32_t block_mask;
  int variant, k, z, log2g;
};

template <int S, int THETA>
int launch_ring(const RingArgs& a, cudaStream_t stream) {
  constexpr int W = S / THETA;
  constexpr int V = W < 4 ? W : 4;
  const unsigned grid = unsigned((a.n + kThreads - 1) / kThreads);
  ring_contains_kernel<S, THETA, V><<<grid, kThreads, 0, stream>>>(
      a.keys, a.rings, a.out, a.salts, a.n, a.n_words, a.n_gen,
      a.block_mask, a.variant, a.k, a.z, a.log2g);
  return int(cudaGetLastError());
}

// At most 16 words a lane (a lane of THETA = 1 at S = 32 spilled).
template <int S>
int dispatch_theta(int theta, const RingArgs& a, cudaStream_t st) {
  switch (theta) {
    case 1:
      if constexpr (S <= 16) return launch_ring<S, 1>(a, st);
      break;
    case 2:
      if constexpr (S >= 2) return launch_ring<S, 2>(a, st);
      break;
    case 4:
      if constexpr (S >= 4) return launch_ring<S, 4>(a, st);
      break;
    case 8:
      if constexpr (S >= 8) return launch_ring<S, 8>(a, st);
      break;
    case 16:
      if constexpr (S >= 16) return launch_ring<S, 16>(a, st);
      break;
    case 32:
      if constexpr (S >= 32) return launch_ring<S, 32>(a, st);
      break;
  }
  return -1;
}

// The binned contains
// ---------------------------------------------------------------------------

// counts[c][j]: keys of chunk c whose block lies in bin j.
__global__ void __launch_bounds__(kBinThreads)
    ring_bin_count_kernel(const uint2* __restrict__ keys,
                          uint32_t* __restrict__ counts, int64_t n,
                          uint32_t block_mask, int bin_shift, int n_bins) {
  extern __shared__ uint32_t hist[];
  for (int j = threadIdx.x; j < n_bins; j += blockDim.x) hist[j] = 0u;
  __syncthreads();
  int64_t first, last;
  chunk_of(n, blockIdx.x, gridDim.x, first, last);
  for (int64_t i = first + threadIdx.x; i < last; i += blockDim.x) {
    uint32_t h_pat, h_blk;
    hash_key(__ldcs(keys + i), h_pat, h_blk);
    atomicAdd(&hist[(h_blk & block_mask) >> bin_shift], 1u);
  }
  __syncthreads();
  uint32_t* row = counts + size_t(blockIdx.x) * n_bins;
  for (int j = threadIdx.x; j < n_bins; j += blockDim.x) row[j] = hist[j];
}

// One CTA a chunk writes its keys' slots, uint4 (key index in the batch,
// pattern hash, row in the bin, 0), into its runs, bins taken `group_bins`
// at a time (a pass over the chunk each). Slot s of a bin is handed out by
// the bin's counter in shared memory; the sector (2 slots) the counter is
// in (`open`) is staged in shared memory and written out whole by the
// thread that fills it, as cbf_bin_scatter_kernel does (its comment sets
// out rounds A-C); here a round is one key a thread (four a thread, as
// cbf's, took 64 registers and ran slower). At the end the last open
// sector is padded with a filler slot (index kFillSlot).
__global__ void __launch_bounds__(kBinThreads, 1)
    ring_bin_scatter_kernel(const uint2* __restrict__ keys,
                            const uint32_t* __restrict__ offsets,
                            const uint32_t* __restrict__ starts,
                            uint4* __restrict__ slots, int64_t n,
                            uint32_t block_mask, int bin_shift, int n_bins,
                            int group_bins) {
  extern __shared__ uint4 sector[];              // 2 slots a bin
  uint32_t* slot = reinterpret_cast<uint32_t*>(sector + 2 * group_bins);
  uint32_t* open = slot + group_bins;
  const uint4 fill = make_uint4(kFillSlot, 0u, 0u, 0u);
  const uint32_t row_mask = (1u << bin_shift) - 1u;
  int64_t first, last;
  chunk_of(n, blockIdx.x, gridDim.x, first, last);
  const int rounds = int((last - first + blockDim.x - 1) / blockDim.x);
  const uint32_t* row = offsets + size_t(blockIdx.x) * n_bins;
  for (int g0 = 0; g0 < n_bins; g0 += group_bins) {
    for (int j = threadIdx.x; j < group_bins; j += blockDim.x) {
      const uint32_t base = starts[g0 + j] + row[g0 + j];
      slot[j] = base;
      open[j] = base >> 1;
    }
    __syncthreads();
    int64_t i = first + threadIdx.x;
    for (int r = 0; r < rounds; ++r, i += blockDim.x) {
      int state = 0;                     // 0 done, 1 staged, 2 kept
      uint32_t lb = 0u, s = 0u;
      uint4 v = fill;
      if (i < last) {                                  // A
        uint32_t h_pat, h_blk;
        hash_key(__ldcs(keys + i), h_pat, h_blk);
        const uint32_t b = h_blk & block_mask;
        lb = (b >> bin_shift) - uint32_t(g0);
        if (lb < uint32_t(group_bins)) {
          v = make_uint4(uint32_t(i), h_pat, b & row_mask, 0u);
          s = atomicAdd(&slot[lb], 1u);
          const uint32_t sec = s >> 1, op = open[lb];
          if (sec == op) {
            sector[2 * lb + (s & 1u)] = v;
            state = 1;
          } else if (sec == op + 1u) {
            state = 2;
          } else {
            slots[s] = v;
          }
        }
      }
      __syncthreads();
      if (state == 1 && (s & 1u) == 1u) {              // B
        slots[s - 1u] = sector[2 * lb];
        slots[s] = sector[2 * lb + 1];
        const uint32_t taken = slot[lb], next = (s >> 1) + 1u;
        open[lb] = taken >= 2u * (next + 1u) ? (taken + 1u) >> 1 : next;
      }
      __syncthreads();
      if (state == 2) {                                // C
        if ((s >> 1) == open[lb])
          sector[2 * lb + (s & 1u)] = v;
        else
          slots[s] = v;
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < group_bins; j += blockDim.x) {
      const uint32_t taken = slot[j];
      if ((taken & 1u) == 0u) continue;       // the run ends on a sector
      if ((taken >> 1) == open[j]) {
        slots[taken - 1u] = sector[2 * j];
        slots[taken] = fill;
      } else {
        slots[taken] = fill;
      }
    }
    __syncthreads();
  }
}

// Whether a row of S words covers the mask of pattern hash h
// (build_mask's bits, each tested against its word as it is placed, so no
// mask array is held).
template <int S>
__device__ __forceinline__ bool row_covers(const uint32_t* row, uint32_t h,
                                           const uint32_t* salt,
                                           const uint32_t* wsalt,
                                           const uint32_t* gsalt,
                                           int variant, int k, int z,
                                           int log2g) {
  uint32_t miss = 0u;
  if (variant == kSbf) {                      // salt i lands in word i % S
    for (int i = 0; i < k; ++i) miss |= bit_of(h, salt[i]) & ~row[i % S];
  } else if (variant == kBbf) {
    constexpr int log2s = log2_of(S);
    for (int i = 0; i < k; ++i) {
      uint32_t w = 0u;
      if constexpr (log2s > 0) w = (h * wsalt[i]) >> (32 - log2s);
      miss |= bit_of(h, salt[i]) & ~row[w];
    }
  } else {                 // csbf: word j*g + mulshift(h, GROUP_SALTS[j])
    const int kz = k / z;
    const int g = S / z;
    for (int jg = 0; jg < z; ++jg) {
      uint32_t w = uint32_t(jg * g);
      if (log2g > 0) w += (h * gsalt[jg]) >> (32 - log2g);
      uint32_t gm = 0u;
      for (int t = 0; t < kz; ++t) gm |= bit_of(h, salt[jg * kz + t]);
      miss |= gm & ~row[w];
    }
  }
  return miss == 0u;
}

// One CTA a bin of 2^log2_bin_words words (its rows in every generation):
// the OR of the G generations' rows into a slice in shared memory (16-byte
// loads where `vec`), then each slot of [starts[j], ends[j]) tests its
// mask against its row and stores the key's result.
template <int S>
__global__ void __launch_bounds__(kBinThreads)
    ring_bin_test_kernel(const uint32_t* __restrict__ rings,
                         const uint4* __restrict__ slots,
                         const uint32_t* __restrict__ starts,
                         const uint32_t* __restrict__ ends,
                         bool* __restrict__ out,
                         const uint32_t* __restrict__ salts, int64_t n_words,
                         int n_gen, int log2_bin_words, int vec, int variant,
                         int k, int z, int log2g) {
  __shared__ uint32_t smem[3 * kMaxSalts];
  extern __shared__ uint4 slice4[];
  uint32_t* slice = reinterpret_cast<uint32_t*>(slice4);
  const uint32_t begin = starts[blockIdx.x], end = ends[blockIdx.x];
  if (begin == end) return;                  // no keys: not read
  stage_salts(smem, salts);
  const uint32_t bin_words = 1u << log2_bin_words;
  const uint32_t* w = rings + (size_t(blockIdx.x) << log2_bin_words);
  if (vec) {
    // streaming loads (evict first): the ring passes through L2 once a
    // batch and should not evict the batch's results
    const uint4* src = reinterpret_cast<const uint4*>(w);
    const int64_t stride = n_words / 4;
    for (uint32_t i = threadIdx.x; i < bin_words / 4; i += blockDim.x) {
      uint4 acc = __ldcs(src + i);
#pragma unroll 4
      for (int g = 1; g < n_gen; ++g) {
        const uint4 a = __ldcs(src + i + g * stride);
        acc.x |= a.x;
        acc.y |= a.y;
        acc.z |= a.z;
        acc.w |= a.w;
      }
      slice4[i] = acc;
    }
  } else {
    for (uint32_t i = threadIdx.x; i < bin_words; i += blockDim.x) {
      uint32_t acc = 0u;
      for (int g = 0; g < n_gen; ++g) acc |= w[i + g * n_words];
      slice[i] = acc;
    }
  }
  __syncthreads();
  for (uint32_t i = begin + threadIdx.x; i < end; i += blockDim.x) {
    const uint4 v = __ldcs(slots + i);
    if (v.x == kFillSlot) continue;
    out[v.x] = row_covers<S>(slice + v.z * uint32_t(S), v.y, smem,
                             smem + kMaxSalts, smem + 2 * kMaxSalts, variant,
                             k, z, log2g);
  }
}

struct BinGeometry {
  int n_bins, bin_shift, log2_bin_words, group_bins;
  size_t count_smem, scatter_smem, test_smem;
};

// The binned kernels' geometry for rows of S words, 2^log2_blocks blocks a
// generation and bins of 2^bin_row_bits rows, or false where they have none.
bool bin_geometry(int s, int log2_blocks, int bin_row_bits, BinGeometry& g) {
  if (log2_blocks < 0 || log2_blocks > 31 || bin_row_bits < 0 ||
      log2_blocks - bin_row_bits > kLog2MaxBins)
    return false;
  g.bin_shift = bin_row_bits < log2_blocks ? bin_row_bits : log2_blocks;
  g.n_bins = 1 << (log2_blocks - g.bin_shift);
  g.log2_bin_words = g.bin_shift + log2_of(s);
  g.group_bins = g.n_bins < kMaxGroupBins ? g.n_bins : kMaxGroupBins;
  g.count_smem = size_t(g.n_bins) * sizeof(uint32_t);
  g.scatter_smem = size_t(g.group_bins) * (2 * sizeof(uint4) +
                                           2 * sizeof(uint32_t));
  g.test_smem = sizeof(uint32_t) << g.log2_bin_words;
  return true;
}

template <int S>
const void* test_kernel() {
  return reinterpret_cast<const void*>(ring_bin_test_kernel<S>);
}

const void* test_kernel_for(int s) {
  switch (s) {
    case 1:
      return test_kernel<1>();
    case 2:
      return test_kernel<2>();
    case 4:
      return test_kernel<4>();
    case 8:
      return test_kernel<8>();
    case 16:
      return test_kernel<16>();
    case 32:
      return test_kernel<32>();
  }
  return nullptr;
}

// Raise the kernels' dynamic shared memory limits; the scatter's CTAs that
// fill the card in *chunks. cudaErrorInvalidValue where the card's shared
// memory does not hold a bin.
cudaError_t prepare_binned(int s, const BinGeometry& g, int* chunks) {
  const void* test = test_kernel_for(s);
  if (test == nullptr) return cudaErrorInvalidValue;
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const size_t salts_smem = 3 * kMaxSalts * sizeof(uint32_t);
  if (g.scatter_smem > size_t(optin) || g.count_smem > size_t(optin) ||
      g.test_smem + salts_smem > size_t(optin))
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(ring_bin_count_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(g.count_smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ring_bin_scatter_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(g.scatter_smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(test,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(g.test_smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ring_bin_scatter_kernel, kBinThreads, g.scatter_smem);
  if (err != cudaSuccess) return err;
  *chunks = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

template <int S>
void launch_test(const BinGeometry& g, const uint32_t* rings,
                 const uint4* slots, const uint32_t* starts,
                 const uint32_t* ends, bool* out, const uint32_t* salts,
                 int64_t n_words, int n_gen, int vec, int variant, int k,
                 int z, int log2g, cudaStream_t st) {
  ring_bin_test_kernel<S><<<g.n_bins, kBinThreads, g.test_smem, st>>>(
      rings, slots, starts, ends, out, salts, n_words, n_gen,
      g.log2_bin_words, vec, variant, k, z, log2g);
}

}  // namespace

extern "C" {

// keys: (n, 2) int32 [hi, lo], 8-byte aligned; rings: (n_gen, n_words)
// int32, 16-byte aligned; out: (n,) bool; salts: (3, 96) int32. theta:
// lanes a key.
int ring_contains(const void* keys, const void* rings, void* out,
                  const void* salts, long long n, long long n_words,
                  int n_gen, unsigned block_mask, int s, int theta,
                  int variant, int k, int z, int log2g, void* stream) {
  if (n_gen < 1) return -1;
  if (n == 0) return 0;
  const RingArgs a{static_cast<const uint2*>(keys),
                   static_cast<const uint32_t*>(rings),
                   static_cast<bool*>(out),
                   static_cast<const uint32_t*>(salts), n, n_words, n_gen,
                   block_mask, variant, k, z, log2g};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (s) {
    case 1:
      return dispatch_theta<1>(theta, a, st);
    case 2:
      return dispatch_theta<2>(theta, a, st);
    case 4:
      return dispatch_theta<4>(theta, a, st);
    case 8:
      return dispatch_theta<8>(theta, a, st);
    case 16:
      return dispatch_theta<16>(theta, a, st);
    case 32:
      return dispatch_theta<32>(theta, a, st);
  }
  return -1;
}

// Chunks (scatter CTAs) of a binned contains on the current device, which
// size its workspace; -1 for a geometry without kernels or an error.
int ring_binned_chunks(int s, int log2_blocks, int bin_row_bits) {
  BinGeometry g;
  int chunks = 0;
  if (!bin_geometry(s, log2_blocks, bin_row_bits, g) ||
      prepare_binned(s, g, &chunks) != cudaSuccess)
    return -1;
  return chunks;
}

// The binned contains (five kernels an internal batch of at most `batch`
// keys). work: u32 workspace, 8-word aligned: counts (chunks x n_bins),
// starts, ends (n_bins each), padded to 8 words, then the 16-byte slots
// (min(n, batch) + chunks * n_bins, each run padded to 2 slots); chunks:
// ring_binned_chunks(). The rings are not written.
int ring_contains_binned(const void* keys, const void* rings, void* out,
                         const void* salts, void* work, long long n,
                         long long n_words, int n_gen, unsigned block_mask,
                         int s, int variant, int k, int z, int log2g,
                         int bin_row_bits, long long batch, int chunks,
                         void* stream) {
  BinGeometry g;
  const int log2_blocks = log2_of(int(block_mask) + 1);
  if (n_gen < 1 || (1u << log2_blocks) != block_mask + 1u ||
      int64_t(block_mask + 1u) * s != n_words ||
      !bin_geometry(s, log2_blocks, bin_row_bits, g) || batch < 1 ||
      batch > (1LL << 31) || chunks < 1 ||
      batch + int64_t(chunks) * g.n_bins > (1LL << 32) - 1)
    return -1;
  if (n == 0) return 0;
  int card_chunks = 0;
  const cudaError_t perr = prepare_binned(s, g, &card_chunks);
  if (perr == cudaErrorInvalidValue) return -1;
  if (perr != cudaSuccess) return int(perr);
  const auto st = static_cast<cudaStream_t>(stream);
  uint32_t* counts = static_cast<uint32_t*>(work);
  uint32_t* starts = counts + size_t(chunks) * g.n_bins;
  uint32_t* ends = starts + g.n_bins;
  const size_t head = (size_t(chunks) + 2) * size_t(g.n_bins);
  uint4* slots = reinterpret_cast<uint4*>(counts + ((head + 7) & ~size_t(7)));
  const uint2* k2 = static_cast<const uint2*>(keys);
  const uint32_t* r = static_cast<const uint32_t*>(rings);
  bool* res = static_cast<bool*>(out);
  const uint32_t* sl = static_cast<const uint32_t*>(salts);
  const int vec = reinterpret_cast<uintptr_t>(rings) % 16 == 0 &&
                  n_words % 4 == 0 && g.log2_bin_words >= 2;
  const unsigned column_grid =
      unsigned((g.n_bins + kColumnThreads - 1) / kColumnThreads);
  for (long long first = 0; first < n; first += batch) {
    const long long nb = n - first < batch ? n - first : batch;
    ring_bin_count_kernel<<<chunks, kBinThreads, g.count_smem, st>>>(
        k2 + first, counts, nb, block_mask, g.bin_shift, g.n_bins);
    bin_column_kernel<<<column_grid, kColumnThreads, 0, st>>>(
        counts, ends, g.n_bins, chunks, 2u);
    bin_scan_kernel<<<1, kBinThreads, 0, st>>>(starts, ends, g.n_bins);
    ring_bin_scatter_kernel<<<chunks, kBinThreads, g.scatter_smem, st>>>(
        k2 + first, counts, starts, slots, nb, block_mask, g.bin_shift,
        g.n_bins, g.group_bins);
    switch (s) {
      case 1:
        launch_test<1>(g, r, slots, starts, ends, res + first, sl, n_words,
                       n_gen, vec, variant, k, z, log2g, st);
        break;
      case 2:
        launch_test<2>(g, r, slots, starts, ends, res + first, sl, n_words,
                       n_gen, vec, variant, k, z, log2g, st);
        break;
      case 4:
        launch_test<4>(g, r, slots, starts, ends, res + first, sl, n_words,
                       n_gen, vec, variant, k, z, log2g, st);
        break;
      case 8:
        launch_test<8>(g, r, slots, starts, ends, res + first, sl, n_words,
                       n_gen, vec, variant, k, z, log2g, st);
        break;
      case 16:
        launch_test<16>(g, r, slots, starts, ends, res + first, sl, n_words,
                        n_gen, vec, variant, k, z, log2g, st);
        break;
      case 32:
        launch_test<32>(g, r, slots, starts, ends, res + first, sl, n_words,
                        n_gen, vec, variant, k, z, log2g, st);
        break;
      default:
        return -1;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  return int(cudaGetLastError());
}

}  // extern "C"
