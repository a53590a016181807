// Classical Bloom filter kernels for Hopper (sm_90a): bulk contains and add
// for the cbf variant, k single-bit probes anywhere in m bits.
//
// Replaces the two Pallas entry points of repro/kernels/cbf.py:
//   cbf_contains_kernel, or the binned contains' five kernels
//                       <- contains_vmem (_contains_kernel)
//   cbf_add_kernel, or the binned add's five cbf_bin_*_kernel
//                       <- add_vmem (_add_kernel)
//
// Design. The classical filter has no block locality: key i's bit t lies at
// pos = ((h1 + t * h2) * SALTS[t]) >> (32 - log2 m) (variants.py
// cbf_positions, Kirsch-Mitzenmacher double hashing re-mixed by a salted
// mul-shift; at m = 2^32 the shift is 0 and all 32 bits are kept), in word
// pos >> 5. The JAX package runs it only with the filter pinned in VMEM (a
// DRAM cbf on the TPU needs k DMAs a key) and sends larger classical filters
// to its jnp engine. On Hopper a probe is one load wherever the word lives,
// so these kernels serve a filter in L2 and one in DRAM; neither the regime
// nor the add's path (kernels/cbf.py choose_path) changes a result.
//
// * cbf_contains_kernel: one thread per key hashes it once (both xxh32
//   streams share the lane products) and walks its k positions in groups of
//   kGroup = 8: the group's 8 word loads are issued together, then tested,
//   and the walk stops after the first group with a miss. A key that is not
//   in the filter fails each probe with probability about 1/2 at the
//   space-optimal fill, so nearly every such key stops after one group, and
//   a member key keeps 8 independent loads in flight. Bound: in the DRAM
//   regime one random 32-byte sector per probe (k sectors for a member key,
//   about 8 for a non-member); in the L2 regime L2 bandwidth and integer
//   issue (~6 integer ops per probe after the ~40 of the hash).
// * cbf_add_kernel: one thread per key, one atomicOr per position (its
//   result unused, so a fire-and-forget reduction). OR commutes and is
//   idempotent, so the words equal the sequential reference bit for bit in
//   any order. Bound: L2 atomic throughput, k atomics a key, on lines
//   fetched from DRAM in the DRAM regime.
//
//   This is the one-pass add. In DRAM it runs at the card's random
//   read-modify-write rate (~14 G atomics a second: 2^28 keys x 11 in
//   207.7 ms on the H100), and the filter's bytes are never its bound.
// * The binned add (cbf_add_binned): OR is order-free and idempotent, so a
//   batch's positions may be grouped by region of the filter in any order
//   and each region ORed in shared memory, then written back once. A bin is
//   2^b contiguous bits (b = bin_bits, 5..20; 64 KiB at b = 19), the whole
//   filter where m <= 2^b; a position's bin is pos >> b (the unmasked u32
//   position, so all 32 bits count at m = 2^32). A batch's keys are cut
//   into `chunks` equal ranges, one CTA a chunk (one an SM). Per internal
//   batch, five kernels on the caller's stream:
//   1. cbf_bin_count_kernel: chunk c hashes its keys once and counts their
//      k positions by bin in shared memory, then stores its row counts[c];
//   2. bin_column_kernel: thread j turns bin j's column into the
//      offsets of the chunks' runs inside the bin, each run padded to a
//      whole 32-byte sector;
//   3. bin_scan_kernel: one CTA scans the <= 8192 bin lengths, giving
//      each bin its slice of the u32 positions workspace;
//   4. cbf_bin_scatter_kernel: chunk c hashes its keys again and writes
//      each position's offset inside its bin into its run; a bin's open
//      sector is staged in shared memory and written whole (comment at
//      the kernel); a run's last sector is padded with kFiller;
//   5. cbf_bin_apply_kernel: one CTA per bin loads the bin's words into
//      shared memory (16-byte loads where the words allow), applies its
//      slice with shared-memory atomicOr (skipping kFiller) and stores the
//      words back; a bin with no positions is neither read nor written.
//   Bins are disjoint, so no two CTAs touch one word. Why exact runs and
//   staged sectors (H100, m = 2^32, 2^28 keys): reserving a tile's run in a
//   bin with a global atomic on the bin's cursor gave runs of ~11
//   positions written over a whole tile, and the scatter took 184 of 195
//   ms; with exact runs, writing each position straight to its slot still
//   left 132 x 8192 sectors filling slowly and took 188 ms; staging each
//   bin's open sector in shared memory takes 23 ms. L2 evicts sectors half
//   written, so a sector has to leave the SM whole (or within one round).
//   Bound: per batch the keys read by the count and by each scatter pass
//   (one a 4096 bins), the positions written and read once (4 B each, plus
//   the runs' padding), the touched bins read and written once; a batch
//   holds at most 2^31 positions, so counts, offsets and slots fit u32.
//
// * The binned contains (cbf_contains_binned): one thread a key is held at
//   DRAM's random-sector rate (2^28 keys x 11 probes in 89.67 ms on the
//   H100, ~33 G sectors a second), which no schedule of one thread a key
//   moves. A contains probes the add's positions, so it runs the add's
//   count and scan kernels as they are and its column kernel with runs
//   padded to 4 slots, then
//   4. cbf_bin_scatter_kernel<uint64_t>: the add's scatter with u64 slots,
//      (the key's index in the internal batch << 32) | the offset, 8 B a
//      slot, 4 a 32-byte sector, so a bin's staging stays the add's 40 B
//      and a pass takes as many bins as the add's (two u32 arrays staged
//      side by side need 72 B a bin and twice the passes: 50.3 ms at 2^20
//      bins, 60.0 at 2^19, on the H100). A second rehash pass cannot find
//      a probe's slot again, since the order inside a run comes from
//      shared-memory atomics;
//   5. cbf_bin_test_kernel: one CTA per bin loads the bin's words into
//      shared memory and never writes them back; a probe that misses
//      stores false to its key's result (out is set to true first; equal
//      stores need no atomics). A bin with no probes is not read.
//   Bins are the add's (2^19 bits): in bins of 2^20 bits (one pass, one
//   test CTA an SM) the contains of the DRAM cell took 51.6 ms against
//   47.0 on the H100. The scatter is bound by its random 32-byte sector
//   writes (~20 G a second), not by its passes. The one-pass kernel's early
//   exit (~8 probes for a key that is not in the filter, not 11) is lost:
//   every probe is binned. Bound: per batch the keys read by the count and
//   each scatter pass, 8 B a slot written and read once, the touched bins
//   read once, the results written once.
//
// The bit salts (SALTS, the first row of the 3 x 96 salt table) are staged
// in shared memory once per CTA. Word offsets are pos >> 5 < 2^27.
//
// C interface for ctypes: each entry point returns cudaGetLastError() after
// its launches, 0 for n == 0 (nothing launched), or -1 for a geometry that
// has no kernel (log2 m outside [5, 32], k outside [1, 96]; for the binned
// add and contains also bin_bits outside [5, 20], more than 8192 bins, a
// batch of more than 2^31 positions, or shared memory the card cannot
// give).

#include "bin_common.cuh"

namespace {

constexpr int kGroup = 8;

__device__ __forceinline__ uint32_t cbf_position(uint32_t h1, uint32_t h2,
                                                 int t, uint32_t salt,
                                                 int shift) {
  return ((h1 + uint32_t(t) * h2) * salt) >> shift;
}

__global__ void __launch_bounds__(kThreads)
    cbf_contains_kernel(const uint2* __restrict__ keys,
                        const uint32_t* __restrict__ words,
                        bool* __restrict__ out,
                        const uint32_t* __restrict__ salts, int64_t n,
                        int shift, int k) {
  __shared__ uint32_t smem[3 * kMaxSalts];
  stage_salts(smem, salts);
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t h1, h2;
  hash_key(keys[i], h1, h2);
  bool ok = true;
  for (int t0 = 0; t0 < k && ok; t0 += kGroup) {
    uint32_t w[kGroup], bit[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {     // issue the group's loads
      const int t = t0 + j;
      if (t < k) {
        const uint32_t pos = cbf_position(h1, h2, t, smem[t], shift);
        w[j] = __ldg(words + (pos >> 5));
        bit[j] = 1u << (pos & 31u);
      } else {
        w[j] = 1u;
        bit[j] = 1u;
      }
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) ok = ok && (w[j] & bit[j]) != 0u;
  }
  out[i] = ok;
}

__global__ void __launch_bounds__(kThreads)
    cbf_add_kernel(const uint2* __restrict__ keys, uint32_t* words,
                   const uint32_t* __restrict__ salts, int64_t n, int shift,
                   int k) {
  __shared__ uint32_t smem[3 * kMaxSalts];
  stage_salts(smem, salts);
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t h1, h2;
  hash_key(keys[i], h1, h2);
  for (int t = 0; t < k; ++t) {
    const uint32_t pos = cbf_position(h1, h2, t, smem[t], shift);
    atomicOr(words + (pos >> 5), 1u << (pos & 31u));
  }
}

// ---------------------------------------------------------------------------
// The binned add
// ---------------------------------------------------------------------------

constexpr int kMinBinBits = 5;                     // one word
constexpr int kMaxBinBits = 20;                    // 128 KiB of shared memory
constexpr int kMaxGroupBins = 4096;                // 40 B a bin in the scatter
constexpr int kRoundProbes = 4;                    // positions a thread a round
constexpr long long kMaxBatchPositions = 1LL << 31;
constexpr uint32_t kFiller = 0xffffffffu;  // pads a run; never an offset

__device__ __forceinline__ void stage_bit_salts(uint32_t* salt,
                                                const uint32_t* salts,
                                                int k) {
  for (int i = threadIdx.x; i < k; i += blockDim.x) salt[i] = salts[i];
}

// counts[c][j]: positions of chunk c's keys in bin j.
__global__ void __launch_bounds__(kBinThreads)
    cbf_bin_count_kernel(const uint2* __restrict__ keys,
                         uint32_t* __restrict__ counts,
                         const uint32_t* __restrict__ salts, int64_t n,
                         int shift, int k, int bin_bits, int n_bins) {
  extern __shared__ uint32_t hist[];
  __shared__ uint32_t salt[kMaxSalts];
  stage_bit_salts(salt, salts, k);
  for (int j = threadIdx.x; j < n_bins; j += blockDim.x) hist[j] = 0u;
  __syncthreads();
  int64_t first, last;
  chunk_of(n, blockIdx.x, gridDim.x, first, last);
  for (int64_t i = first + threadIdx.x; i < last; i += blockDim.x) {
    uint32_t h1, h2;
    hash_key(keys[i], h1, h2);
    for (int t = 0; t < k; ++t)
      atomicAdd(&hist[cbf_position(h1, h2, t, salt[t], shift) >> bin_bits],
                1u);
  }
  __syncthreads();
  uint32_t* row = counts + size_t(blockIdx.x) * n_bins;
  for (int j = threadIdx.x; j < n_bins; j += blockDim.x) row[j] = hist[j];
}

// A slot of the positions workspace: the add's u32 offset inside its bin,
// or the contains' u64 (key index in the batch << 32 | offset). A 32-byte
// sector holds kSlots of them; a filler slot is all ones.
template <typename T>
struct Slot {
  static constexpr uint32_t kSlots = 32 / sizeof(T);
  static constexpr uint32_t kShift = kSlots == 8 ? 3 : 2;
  static constexpr T kFill = T(~T(0));
  __device__ __forceinline__ static T make(uint32_t off, int64_t key) {
    if constexpr (sizeof(T) == 4)
      return off;
    else
      return (uint64_t(uint32_t(key)) << 32) | off;
  }
};

// One CTA a chunk writes its keys' positions (their offsets inside the bin)
// into its runs, bins taken `group_bins` at a time (a pass over the chunk
// each). Each bin's run starts on a sector, and slot s of a bin is written
// once: the bin's counter in shared memory hands out s. The sector the
// counter is in (`open`) is staged in shared memory and written out whole,
// as two 16-byte stores, by the thread that fills it. A round is up to
// kRoundProbes positions a thread:
//   A: take a slot; stage it in the open sector, keep it (the next sector),
//      or, further on, write it to the workspace (a sector filled within
//      one round is written in one burst, which L2 merges);
//   B: the thread that took a sector's last slot writes the sector; the
//      next sector opens, or the first untouched one if the round went past
//      it;
//   C: the kept slots go to the open sector, else to the workspace.
// At the end the last open sector is padded with filler to the run's end.
// Dynamic shared memory: 32 B of sector, a counter and a sector index a bin.
// T = uint64_t (the binned contains): a slot also holds its key's index in
// the batch, 4 slots a sector, so a bin's staging is the add's 40 B.
template <typename T>
__global__ void __launch_bounds__(kBinThreads, 1)
    cbf_bin_scatter_kernel(const uint2* __restrict__ keys,
                           const uint32_t* __restrict__ offsets,
                           const uint32_t* __restrict__ starts,
                           T* __restrict__ positions,
                           const uint32_t* __restrict__ salts, int64_t n,
                           int shift, int k, int bin_bits, int n_bins,
                           int group_bins, uint32_t offset_mask) {
  using S = Slot<T>;
  constexpr uint32_t kLast = S::kSlots - 1u;
  extern __shared__ uint4 sector4[];
  T* sector = reinterpret_cast<T*>(sector4);
  uint32_t* slot = reinterpret_cast<uint32_t*>(sector + S::kSlots *
                                               group_bins);
  uint32_t* open = slot + group_bins;
  __shared__ uint32_t salt[kMaxSalts];
  stage_bit_salts(salt, salts, k);
  int64_t first, last;
  chunk_of(n, blockIdx.x, gridDim.x, first, last);
  const int rounds = int((last - first + blockDim.x - 1) / blockDim.x);
  const uint32_t* row = offsets + size_t(blockIdx.x) * n_bins;
  for (int g0 = 0; g0 < n_bins; g0 += group_bins) {
    for (int j = threadIdx.x; j < group_bins; j += blockDim.x) {
      const uint32_t base = starts[g0 + j] + row[g0 + j];
      slot[j] = base;
      open[j] = base >> S::kShift;
    }
    __syncthreads();
    int64_t i = first + threadIdx.x;
    uint2 key = i < last ? keys[i] : make_uint2(0u, 0u);
    for (int r = 0; r < rounds; ++r, i += blockDim.x) {
      const bool live = i < last;
      uint32_t h1 = 0u, h2 = 0u;
      if (live) hash_key(key, h1, h2);
      if (i + blockDim.x < last) key = keys[i + blockDim.x];  // next round's
      for (int t0 = 0; t0 < k; t0 += kRoundProbes) {
        uint32_t lb[kRoundProbes], s[kRoundProbes], off[kRoundProbes];
        int state[kRoundProbes];             // 0 done, 1 staged, 2 kept
#pragma unroll
        for (int u = 0; u < kRoundProbes; ++u) {          // A
          state[u] = 0;
          lb[u] = s[u] = off[u] = 0u;
          const int t = t0 + u;
          if (!live || t >= k) continue;
          const uint32_t pos = cbf_position(h1, h2, t, salt[t], shift);
          lb[u] = (pos >> bin_bits) - uint32_t(g0);
          if (lb[u] >= uint32_t(group_bins)) continue;
          off[u] = pos & offset_mask;
          s[u] = atomicAdd(&slot[lb[u]], 1u);
          const uint32_t sec = s[u] >> S::kShift, op = open[lb[u]];
          if (sec == op) {
            sector[S::kSlots * lb[u] + (s[u] & kLast)] = S::make(off[u], i);
            state[u] = 1;
          } else if (sec == op + 1u) {
            state[u] = 2;
          } else {
            positions[s[u]] = S::make(off[u], i);
          }
        }
        __syncthreads();
#pragma unroll
        for (int u = 0; u < kRoundProbes; ++u) {          // B
          if (state[u] != 1 || (s[u] & kLast) != kLast) continue;
          uint4* dst = reinterpret_cast<uint4*>(positions + (s[u] & ~kLast));
          dst[0] = sector4[2 * lb[u]];
          dst[1] = sector4[2 * lb[u] + 1];
          const uint32_t taken = slot[lb[u]], next = (s[u] >> S::kShift) + 1u;
          open[lb[u]] = taken >= S::kSlots * (next + 1u)
                            ? (taken + kLast) >> S::kShift
                            : next;
        }
        __syncthreads();
#pragma unroll
        for (int u = 0; u < kRoundProbes; ++u) {          // C
          if (state[u] != 2) continue;
          if ((s[u] >> S::kShift) == open[lb[u]])
            sector[S::kSlots * lb[u] + (s[u] & kLast)] = S::make(off[u], i);
          else
            positions[s[u]] = S::make(off[u], i);
        }
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < group_bins; j += blockDim.x) {
      const uint32_t taken = slot[j];
      if ((taken & kLast) == 0u) continue;   // the run ends on a sector
      if ((taken >> S::kShift) == open[j]) {
        for (uint32_t q = taken & kLast; q <= kLast; ++q)
          sector[S::kSlots * j + q] = S::kFill;
        uint4* dst = reinterpret_cast<uint4*>(positions + (taken & ~kLast));
        dst[0] = sector4[2 * j];
        dst[1] = sector4[2 * j + 1];
      } else {
        for (uint32_t q = taken; q < ((taken + kLast) & ~kLast); ++q)
          positions[q] = S::kFill;
      }
    }
    __syncthreads();
  }
}

// One CTA per bin of 2^log2_bin_words words; [starts[j], ends[j]) is the
// bin's slice (offsets inside the bin, and kFiller). vec: words 16-byte
// aligned and >= 4 words a bin.
__global__ void __launch_bounds__(kBinThreads)
    cbf_bin_apply_kernel(uint32_t* __restrict__ words,
                         const uint32_t* __restrict__ positions,
                         const uint32_t* __restrict__ starts,
                         const uint32_t* __restrict__ ends,
                         int log2_bin_words, int vec) {
  extern __shared__ uint4 bin4[];
  uint32_t* bin = reinterpret_cast<uint32_t*>(bin4);
  const uint32_t begin = starts[blockIdx.x], end = ends[blockIdx.x];
  if (begin == end) return;                  // untouched: not read or written
  const uint32_t n_words = 1u << log2_bin_words;
  uint32_t* w = words + (size_t(blockIdx.x) << log2_bin_words);
  if (vec) {
    const uint4* src = reinterpret_cast<const uint4*>(w);
    for (uint32_t i = threadIdx.x; i < n_words / 4; i += blockDim.x)
      bin4[i] = src[i];
  } else {
    for (uint32_t i = threadIdx.x; i < n_words; i += blockDim.x) bin[i] = w[i];
  }
  __syncthreads();
  for (uint32_t i = begin + threadIdx.x; i < end; i += blockDim.x) {
    const uint32_t p = positions[i];
    if (p != kFiller) atomicOr(&bin[p >> 5], 1u << (p & 31u));
  }
  __syncthreads();
  if (vec) {
    uint4* dst = reinterpret_cast<uint4*>(w);
    for (uint32_t i = threadIdx.x; i < n_words / 4; i += blockDim.x)
      dst[i] = bin4[i];
  } else {
    for (uint32_t i = threadIdx.x; i < n_words; i += blockDim.x) w[i] = bin[i];
  }
}

// The binned contains' test: one CTA per bin loads the bin's words into
// shared memory (16-byte loads where the words allow) and never writes them
// back; each slot of its slice that is not filler tests its bit and, on a
// miss, stores false to its key's result (out starts all true; stores of
// the same value need no atomics). A bin with no probes is not read.
__global__ void __launch_bounds__(kBinThreads)
    cbf_bin_test_kernel(const uint32_t* __restrict__ words,
                        const uint64_t* __restrict__ slots,
                        const uint32_t* __restrict__ starts,
                        const uint32_t* __restrict__ ends,
                        bool* __restrict__ out, int log2_bin_words, int vec) {
  extern __shared__ uint4 bin4[];
  uint32_t* bin = reinterpret_cast<uint32_t*>(bin4);
  const uint32_t begin = starts[blockIdx.x], end = ends[blockIdx.x];
  if (begin == end) return;                  // no probes: not read
  const uint32_t n_words = 1u << log2_bin_words;
  const uint32_t* w = words + (size_t(blockIdx.x) << log2_bin_words);
  if (vec) {
    const uint4* src = reinterpret_cast<const uint4*>(w);
    for (uint32_t i = threadIdx.x; i < n_words / 4; i += blockDim.x)
      bin4[i] = src[i];
  } else {
    for (uint32_t i = threadIdx.x; i < n_words; i += blockDim.x) bin[i] = w[i];
  }
  __syncthreads();
  for (uint32_t i = begin + threadIdx.x; i < end; i += blockDim.x) {
    const uint64_t v = slots[i];
    const uint32_t p = uint32_t(v);
    if (p != kFiller && ((bin[p >> 5] >> (p & 31u)) & 1u) == 0u)
      out[uint32_t(v >> 32)] = false;
  }
}

struct BinGeometry {
  int n_bins, log2_bin_words, group_bins;
  size_t count_smem, scatter_smem, apply_smem;
  bool keys;                                 // the contains' u64 slots
};

// The binned kernels' geometry, or false where they have none. keys: the
// contains' kernels (u64 slots).
bool bin_geometry(int log2m, int k, int bin_bits, bool keys,
                  BinGeometry& g) {
  if (log2m < 5 || log2m > 32 || k < 1 || k > kMaxSalts ||
      bin_bits < kMinBinBits || bin_bits > kMaxBinBits ||
      log2m - bin_bits > kLog2MaxBins)
    return false;
  g.n_bins = 1 << (log2m > bin_bits ? log2m - bin_bits : 0);
  g.log2_bin_words = (log2m < bin_bits ? log2m : bin_bits) - 5;
  g.group_bins = g.n_bins < kMaxGroupBins ? g.n_bins : kMaxGroupBins;
  g.count_smem = size_t(g.n_bins) * sizeof(uint32_t);
  g.scatter_smem = size_t(g.group_bins) * 10 * sizeof(uint32_t);
  g.apply_smem = sizeof(uint32_t) << g.log2_bin_words;
  g.keys = keys;
  return true;
}

// Raise the kernels' dynamic shared memory limits; CTAs of the scatter
// that fill the card (the chunks of a batch) in *chunks.
cudaError_t prepare_binned(const BinGeometry& g, int* chunks) {
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const size_t salts_smem = kMaxSalts * sizeof(uint32_t);
  if (g.scatter_smem + salts_smem > size_t(optin) ||
      g.count_smem + salts_smem > size_t(optin) ||
      g.apply_smem > size_t(optin))
    return cudaErrorInvalidValue;
  const void* scatter =
      g.keys ? reinterpret_cast<const void*>(cbf_bin_scatter_kernel<uint64_t>)
             : reinterpret_cast<const void*>(cbf_bin_scatter_kernel<uint32_t>);
  const void* last =
      g.keys ? reinterpret_cast<const void*>(cbf_bin_test_kernel)
             : reinterpret_cast<const void*>(cbf_bin_apply_kernel);
  err = cudaFuncSetAttribute(cbf_bin_count_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(g.count_smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(scatter,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(g.scatter_smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(last,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(g.apply_smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, scatter, kBinThreads, g.scatter_smem);
  if (err != cudaSuccess) return err;
  *chunks = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

// The arguments of a binned call: its geometry in g, or false where the
// kernels take none.
bool binned_args(int log2m, int k, int bin_bits, bool keys, long long batch,
                 int chunks, BinGeometry& g) {
  return bin_geometry(log2m, k, bin_bits, keys, g) && batch >= 1 &&
         batch * k <= kMaxBatchPositions && chunks >= 1 &&
         7LL * chunks * g.n_bins <= kMaxBatchPositions;
}

// prepare_binned for a call: 0, -1 for shared memory the card cannot
// give, or a CUDA error.
int prepare_call(const BinGeometry& g) {
  int card_chunks = 0;
  const cudaError_t err = prepare_binned(g, &card_chunks);
  if (err == cudaErrorInvalidValue) return -1;
  return int(err);
}

bool bad_geometry(int log2m, int k) {
  return log2m < 5 || log2m > 32 || k < 1 || k > kMaxSalts;
}

unsigned grid_for(long long n) {
  return unsigned((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// keys: (n, 2) int32 [hi, lo], 8-byte aligned; words: (m / 32,) int32;
// out: (n,) bool; salts: (3, 96) int32; log2m = log2(m_bits).
int cbf_contains(const void* keys, const void* words, void* out,
                 const void* salts, long long n, int log2m, int k,
                 void* stream) {
  if (bad_geometry(log2m, k)) return -1;
  if (n == 0) return 0;
  cbf_contains_kernel<<<grid_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(keys), static_cast<const uint32_t*>(words),
      static_cast<bool*>(out), static_cast<const uint32_t*>(salts), n,
      32 - log2m, k);
  return int(cudaGetLastError());
}

int cbf_add(const void* keys, void* words, const void* salts, long long n,
            int log2m, int k, void* stream) {
  if (bad_geometry(log2m, k)) return -1;
  if (n == 0) return 0;
  cbf_add_kernel<<<grid_for(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(keys), static_cast<uint32_t*>(words),
      static_cast<const uint32_t*>(salts), n, 32 - log2m, k);
  return int(cudaGetLastError());
}

// Chunks (scatter CTAs) of a binned add (keys 0) or contains (keys 1) on
// the current device, which size its workspace; -1 for a geometry without
// kernels or an error.
int cbf_binned_chunks(int log2m, int k, int bin_bits, int keys) {
  BinGeometry g;
  int chunks = 0;
  if (!bin_geometry(log2m, k, bin_bits, keys != 0, g) ||
      prepare_binned(g, &chunks) != cudaSuccess)
    return -1;
  return chunks;
}

// The binned add (five kernels an internal batch). work: u32 workspace,
// 8-word aligned: counts (chunks x n_bins), starts, ends (n_bins each),
// padded to 8 words, then the positions (batch * k + 7 * chunks * n_bins,
// each bin's runs padded to sectors); batch: keys an internal batch,
// batch * k <= 2^31; chunks: cbf_binned_chunks(). Updates words in place.
int cbf_add_binned(const void* keys, void* words, const void* salts,
                   void* work, long long n, int log2m, int k, int bin_bits,
                   long long batch, int chunks, void* stream) {
  BinGeometry g;
  if (!binned_args(log2m, k, bin_bits, false, batch, chunks, g)) return -1;
  if (n == 0) return 0;
  const int bad = prepare_call(g);
  if (bad) return bad;
  const auto s = static_cast<cudaStream_t>(stream);
  uint32_t* counts = static_cast<uint32_t*>(work);
  uint32_t* starts = counts + size_t(chunks) * g.n_bins;
  uint32_t* ends = starts + g.n_bins;
  const size_t head = (size_t(chunks) + 2) * size_t(g.n_bins);
  uint32_t* positions = counts + ((head + 7) & ~size_t(7));
  const uint2* k2 = static_cast<const uint2*>(keys);
  uint32_t* w = static_cast<uint32_t*>(words);
  const uint32_t* sl = static_cast<const uint32_t*>(salts);
  const int vec = (reinterpret_cast<uintptr_t>(words) % 16 == 0 &&
                   g.log2_bin_words >= 2);
  const int shift = 32 - log2m;
  const uint32_t offset_mask = (32u << g.log2_bin_words) - 1u;
  const unsigned column_grid =
      unsigned((g.n_bins + kColumnThreads - 1) / kColumnThreads);
  for (long long first = 0; first < n; first += batch) {
    const long long nb = n - first < batch ? n - first : batch;
    cbf_bin_count_kernel<<<chunks, kBinThreads, g.count_smem, s>>>(
        k2 + first, counts, sl, nb, shift, k, bin_bits, g.n_bins);
    bin_column_kernel<<<column_grid, kColumnThreads, 0, s>>>(
        counts, ends, g.n_bins, chunks, Slot<uint32_t>::kSlots);
    bin_scan_kernel<<<1, kBinThreads, 0, s>>>(starts, ends, g.n_bins);
    cbf_bin_scatter_kernel<uint32_t>
        <<<chunks, kBinThreads, g.scatter_smem, s>>>(
            k2 + first, counts, starts, positions, sl, nb, shift, k,
            bin_bits, g.n_bins, g.group_bins, offset_mask);
    cbf_bin_apply_kernel<<<g.n_bins, kBinThreads, g.apply_smem, s>>>(
        w, positions, starts, ends, g.log2_bin_words, vec);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  return int(cudaGetLastError());
}

// The binned contains (five kernels an internal batch: the add's count,
// column and scan, the scatter of u64 slots, the test). work: the counts,
// starts and ends as for cbf_add_binned, padded to 8 words, then the u64
// slots (min(n, batch) * k + 3 * chunks * n_bins, each run padded to 4
// slots, a sector); out: (n,) bool, set to true here first. The filter is
// not written.
int cbf_contains_binned(const void* keys, const void* words, void* out,
                        const void* salts, void* work, long long n,
                        int log2m, int k, int bin_bits, long long batch,
                        int chunks, void* stream) {
  BinGeometry g;
  if (!binned_args(log2m, k, bin_bits, true, batch, chunks, g)) return -1;
  if (n == 0) return 0;
  const int bad = prepare_call(g);
  if (bad) return bad;
  const auto s = static_cast<cudaStream_t>(stream);
  uint32_t* counts = static_cast<uint32_t*>(work);
  uint32_t* starts = counts + size_t(chunks) * g.n_bins;
  uint32_t* ends = starts + g.n_bins;
  const size_t head = (size_t(chunks) + 2) * size_t(g.n_bins);
  uint64_t* slots =
      reinterpret_cast<uint64_t*>(counts + ((head + 7) & ~size_t(7)));
  const uint2* k2 = static_cast<const uint2*>(keys);
  const uint32_t* w = static_cast<const uint32_t*>(words);
  bool* res = static_cast<bool*>(out);
  const uint32_t* sl = static_cast<const uint32_t*>(salts);
  const int vec = (reinterpret_cast<uintptr_t>(words) % 16 == 0 &&
                   g.log2_bin_words >= 2);
  const int shift = 32 - log2m;
  const uint32_t offset_mask = (32u << g.log2_bin_words) - 1u;
  const unsigned column_grid =
      unsigned((g.n_bins + kColumnThreads - 1) / kColumnThreads);
  cudaError_t err = cudaMemsetAsync(out, 1, size_t(n), s);
  if (err != cudaSuccess) return int(err);
  for (long long first = 0; first < n; first += batch) {
    const long long nb = n - first < batch ? n - first : batch;
    cbf_bin_count_kernel<<<chunks, kBinThreads, g.count_smem, s>>>(
        k2 + first, counts, sl, nb, shift, k, bin_bits, g.n_bins);
    bin_column_kernel<<<column_grid, kColumnThreads, 0, s>>>(
        counts, ends, g.n_bins, chunks, Slot<uint64_t>::kSlots);
    bin_scan_kernel<<<1, kBinThreads, 0, s>>>(starts, ends, g.n_bins);
    cbf_bin_scatter_kernel<uint64_t>
        <<<chunks, kBinThreads, g.scatter_smem, s>>>(
            k2 + first, counts, starts, slots, sl, nb, shift, k, bin_bits,
            g.n_bins, g.group_bins, offset_mask);
    cbf_bin_test_kernel<<<g.n_bins, kBinThreads, g.apply_smem, s>>>(
        w, slots, starts, ends, res + first, g.log2_bin_words, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  return int(cudaGetLastError());
}

}  // extern "C"
