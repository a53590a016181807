// The stages the binned kernels of cbf.cu (the classical add and contains),
// counting.cu (the counting update), ring.cu and quotient.cu (the binned
// contains) share: a chunk's key range, each bin's per-chunk runs padded to
// whole 32-byte sectors, and the scan of the bins' lengths into their
// slices of the slot workspace; for quotient.cu also the count and scatter
// of 8-byte slots, generic in how a key finds its bin.
// Everything sits in an anonymous namespace, so each library that includes
// it gets its own copy.

#pragma once

#include "bloom_common.cuh"

namespace {

constexpr int kBinThreads = 1024;
constexpr int kColumnThreads = 256;
constexpr int kLog2MaxBins = 13;
constexpr int kMaxBins = 1 << kLog2MaxBins;        // 32 KiB of histogram
constexpr int kScanPer = kMaxBins / kBinThreads;   // totals a scan thread

// Keys [first, last) of chunk `c` of `chunks`: the count and the scatter
// kernels run one CTA a chunk, with the same bounds.
__device__ __forceinline__ void chunk_of(int64_t n, int c, int chunks,
                                         int64_t& first, int64_t& last) {
  first = int64_t(c) * n / chunks;
  last = int64_t(c + 1) * n / chunks;
}

// Thread j walks bin j's column: counts[c][j] becomes the offset of chunk
// c's run inside the bin, each run padded to a whole 32-byte sector (a
// multiple of `sector` slots: 8 u32 or 4 u64); totals[j] is the bin's
// padded length.
__global__ void __launch_bounds__(kColumnThreads)
    bin_column_kernel(uint32_t* __restrict__ counts,
                      uint32_t* __restrict__ totals, int n_bins, int chunks,
                      uint32_t sector) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_bins) return;
  uint32_t run = 0u;
#pragma unroll 8
  for (int c = 0; c < chunks; ++c) {
    uint32_t* cell = counts + size_t(c) * n_bins + j;
    const uint32_t v = *cell;
    *cell = run;
    run += (v + sector - 1u) & ~(sector - 1u);
  }
  totals[j] = run;
}

// One CTA: the exclusive scan of the <= 8192 bin lengths (warp shuffles,
// then the 32 warp sums). In: ends[j] = the length of bin j. Out: starts[j]
// and ends[j], the bin's slice of the slots.
__global__ void __launch_bounds__(kBinThreads)
    bin_scan_kernel(uint32_t* __restrict__ starts,
                    uint32_t* __restrict__ ends, int n_bins) {
  __shared__ uint32_t warp_sums[kBinThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = threadIdx.x * kScanPer;
  uint32_t v[kScanPer];
  uint32_t sum = 0u;
#pragma unroll
  for (int j = 0; j < kScanPer; ++j) {
    v[j] = first + j < n_bins ? ends[first + j] : 0u;
    sum += v[j];
  }
  uint32_t incl = sum;                       // inclusive scan over the warp
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
  uint32_t run = incl - sum + (warp > 0 ? warp_sums[warp - 1] : 0u);
#pragma unroll
  for (int j = 0; j < kScanPer; ++j) {
    if (first + j < n_bins) {
      starts[first + j] = run;
      ends[first + j] = run + v[j];
    }
    run += v[j];
  }
}

// ---------------------------------------------------------------------------
// 8-byte slots (the quotient binned contains). A binner gives a key its bin
// and a 32-bit payload:
//   __device__ uint32_t operator()(uint2 key, uint32_t& payload) const;
// and key i of the batch gets the slot (payload << 32) | i. A slot of all
// ones pads a run (no batch holds 2^32 - 1 keys).
// ---------------------------------------------------------------------------

constexpr uint64_t kFill8 = ~uint64_t(0);
constexpr int kMaxGroupBins8 = 4096;     // 40 B a bin in the scatter

// counts[c][j]: keys of chunk c whose bin is j.
template <class Binner>
__global__ void __launch_bounds__(kBinThreads)
    bin8_count_kernel(const uint2* __restrict__ keys,
                      uint32_t* __restrict__ counts, int64_t n, int n_bins,
                      Binner binner) {
  extern __shared__ uint32_t hist8[];
  for (int j = threadIdx.x; j < n_bins; j += blockDim.x) hist8[j] = 0u;
  __syncthreads();
  int64_t first, last;
  chunk_of(n, blockIdx.x, gridDim.x, first, last);
#pragma unroll 4
  for (int64_t i = first + threadIdx.x; i < last; i += blockDim.x) {
    uint32_t payload;
    atomicAdd(&hist8[binner(__ldcs(keys + i), payload)], 1u);
  }
  __syncthreads();
  uint32_t* row = counts + size_t(blockIdx.x) * n_bins;
  for (int j = threadIdx.x; j < n_bins; j += blockDim.x) row[j] = hist8[j];
}

// One CTA a chunk writes its keys' slots into its runs (the offsets of
// bin_column_kernel with 4-slot sectors, bin_scan_kernel's starts), bins
// taken `group_bins` at a time (a pass over the chunk each): the schedule of
// ring_bin_scatter_kernel with 4 slots a 32-byte sector. Slot s of a bin is
// handed out by the bin's counter in shared memory; the sector the counter
// is in (`open`) is staged in shared memory and written whole, as two
// 16-byte stores, by the thread that fills it (L2 evicts sectors half
// written). A round is one key a thread (the next round's key loads
// during it):
//   A: take a slot; stage it in the open sector, keep it (the next
//      sector), or, further on, write it to the workspace;
//   B: the thread that took a sector's last slot writes the sector; the
//      next sector opens, or the first untouched one;
//   C: the kept slots go to the open sector, else to the workspace.
// At the end the last open sector is padded with filler slots.
template <class Binner>
__global__ void __launch_bounds__(kBinThreads, 1)
    bin8_scatter_kernel(const uint2* __restrict__ keys,
                        const uint32_t* __restrict__ offsets,
                        const uint32_t* __restrict__ starts,
                        uint64_t* __restrict__ slots, int64_t n, int n_bins,
                        int group_bins, Binner binner) {
  extern __shared__ uint4 sector4[];             // 4 slots a bin
  uint64_t* sector = reinterpret_cast<uint64_t*>(sector4);
  uint32_t* slot = reinterpret_cast<uint32_t*>(sector + 4 * group_bins);
  uint32_t* open = slot + group_bins;
  int64_t first, last;
  chunk_of(n, blockIdx.x, gridDim.x, first, last);
  const int rounds = int((last - first + blockDim.x - 1) / blockDim.x);
  const uint32_t* row = offsets + size_t(blockIdx.x) * n_bins;
  for (int g0 = 0; g0 < n_bins; g0 += group_bins) {
    for (int j = threadIdx.x; j < group_bins; j += blockDim.x) {
      const uint32_t base = starts[g0 + j] + row[g0 + j];
      slot[j] = base;
      open[j] = base >> 2;
    }
    __syncthreads();
    int64_t i = first + threadIdx.x;
    uint2 key = i < last ? __ldcs(keys + i) : make_uint2(0u, 0u);
    for (int r = 0; r < rounds; ++r, i += blockDim.x) {
      int state = 0;                     // 0 done, 1 staged, 2 kept
      uint32_t lb = 0u, s = 0u;
      uint64_t v = kFill8;
      const uint2 cur = key;             // the next round's key loads now
      if (i + blockDim.x < last) key = __ldcs(keys + i + blockDim.x);
      if (i < last) {                                  // A
        uint32_t payload;
        lb = binner(cur, payload) - uint32_t(g0);
        if (lb < uint32_t(group_bins)) {
          v = (uint64_t(payload) << 32) | uint64_t(uint32_t(i));
          s = atomicAdd(&slot[lb], 1u);
          const uint32_t sec = s >> 2, op = open[lb];
          if (sec == op) {
            sector[4 * lb + (s & 3u)] = v;
            state = 1;
          } else if (sec == op + 1u) {
            state = 2;
          } else {
            slots[s] = v;
          }
        }
      }
      __syncthreads();
      if (state == 1 && (s & 3u) == 3u) {              // B
        uint4* dst = reinterpret_cast<uint4*>(slots + (s & ~3u));
        dst[0] = sector4[2 * lb];
        dst[1] = sector4[2 * lb + 1];
        const uint32_t taken = slot[lb], next = (s >> 2) + 1u;
        open[lb] = taken >= 4u * (next + 1u) ? (taken + 3u) >> 2 : next;
      }
      __syncthreads();
      if (state == 2) {                                // C
        if ((s >> 2) == open[lb])
          sector[4 * lb + (s & 3u)] = v;
        else
          slots[s] = v;
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < group_bins; j += blockDim.x) {
      const uint32_t taken = slot[j];
      if ((taken & 3u) == 0u) continue;       // the run ends on a sector
      if ((taken >> 2) == open[j]) {
        for (uint32_t q = taken & 3u; q < 4u; ++q) sector[4 * j + q] = kFill8;
        uint4* dst = reinterpret_cast<uint4*>(slots + (taken & ~3u));
        dst[0] = sector4[2 * j];
        dst[1] = sector4[2 * j + 1];
      } else {
        for (uint32_t q = taken; q < ((taken + 3u) & ~3u); ++q)
          slots[q] = kFill8;
      }
    }
    __syncthreads();
  }
}

struct Bin8Geometry {
  int n_bins, group_bins;
  size_t count_smem, scatter_smem;
};

inline Bin8Geometry bin8_geometry(int n_bins) {
  Bin8Geometry g;
  g.n_bins = n_bins;
  g.group_bins = n_bins < kMaxGroupBins8 ? n_bins : kMaxGroupBins8;
  g.count_smem = size_t(n_bins) * sizeof(uint32_t);
  g.scatter_smem = size_t(g.group_bins) * (4 * sizeof(uint64_t) +
                                           2 * sizeof(uint32_t));
  return g;
}

// The host work of a binned call is kept once a device (a call's host time
// shows in small batches): the card's limits, each kernel's raised shared
// memory limit, the scatter's occupancy. Racing callers store the same
// values.
constexpr int kMaxDevices = 64;

// The card's opt-in shared memory a CTA and its SMs (the current device).
inline cudaError_t card_limits(int* optin, int* sms) {
  static int known_optin[kMaxDevices], known_sms[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && known_sms[dev] > 0) {
    *optin = known_optin[dev];
    *sms = known_sms[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kMaxDevices) {
    known_optin[dev] = *optin;
    known_sms[dev] = *sms;
  }
  return err;
}

// Raise `kernel`'s dynamic shared memory limit to what the card's opt-in
// limit leaves beside its static shared memory, once a kernel and device
// (kept by the kernel's address: instances of one template share a
// signature); *dynamic gets that room.
template <class Kernel>
cudaError_t raise_smem(Kernel kernel, int* dynamic) {
  constexpr int kKnown = 256;
  static const void* known_fn[kKnown];
  static int known_dev[kKnown], known_room[kKnown], n_known;
  const void* fn = reinterpret_cast<const void*>(kernel);
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < n_known && i < kKnown; ++i) {
    if (known_fn[i] == fn && known_dev[i] == dev) {
      *dynamic = known_room[i];
      return cudaSuccess;
    }
  }
  cudaFuncAttributes fa;
  err = card_limits(&optin, &sms);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  *dynamic = optin - int(fa.sharedSizeBytes);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *dynamic);
  if (err == cudaSuccess && n_known < kKnown) {
    known_fn[n_known] = fn;
    known_dev[n_known] = dev;
    known_room[n_known] = *dynamic;
    ++n_known;
  }
  return err;
}

// Raise the count and scatter kernels of a binner to the card's shared
// memory limit; *chunks: the scatter's CTAs that fill the card.
// cudaErrorInvalidValue where the card's shared memory does not hold the
// geometry.
template <class Binner>
cudaError_t bin8_prepare(const Bin8Geometry& g, int* chunks) {
  static int known[kMaxDevices][kLog2MaxBins + 1];   // chunks by log2 bins
  int dev = 0, count_room = 0, scatter_room = 0, sms = 0, optin = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int lb = 0;
  while ((1 << lb) < g.n_bins) ++lb;
  const bool cached = dev < kMaxDevices && lb <= kLog2MaxBins &&
                      (1 << lb) == g.n_bins && known[dev][lb] > 0;
  err = raise_smem(bin8_count_kernel<Binner>, &count_room);
  if (err == cudaSuccess)
    err = raise_smem(bin8_scatter_kernel<Binner>, &scatter_room);
  if (err != cudaSuccess) return err;
  if (g.count_smem > size_t(count_room) ||
      g.scatter_smem > size_t(scatter_room))
    return cudaErrorInvalidValue;
  if (cached) {
    *chunks = known[dev][lb];
    return cudaSuccess;
  }
  err = card_limits(&optin, &sms);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bin8_scatter_kernel<Binner>, kBinThreads, g.scatter_smem);
  if (err != cudaSuccess) return err;
  *chunks = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices && lb <= kLog2MaxBins && (1 << lb) == g.n_bins)
    known[dev][lb] = *chunks;
  return cudaSuccess;
}

// Stages 1-4 of a binned batch: count, column (runs padded to 4 slots),
// scan, scatter; starts[j] / ends[j] give bin j's slice of `slots`.
template <class Binner>
void bin8_stages(const uint2* keys, int64_t n, const Bin8Geometry& g,
                 int chunks, Binner binner, uint32_t* counts,
                 uint32_t* starts, uint32_t* ends, uint64_t* slots,
                 cudaStream_t st) {
  bin8_count_kernel<Binner><<<chunks, kBinThreads, g.count_smem, st>>>(
      keys, counts, n, g.n_bins, binner);
  bin_column_kernel<<<unsigned((g.n_bins + kColumnThreads - 1) /
                               kColumnThreads),
                      kColumnThreads, 0, st>>>(counts, ends, g.n_bins, chunks,
                                               4u);
  bin_scan_kernel<<<1, kBinThreads, 0, st>>>(starts, ends, g.n_bins);
  bin8_scatter_kernel<Binner><<<chunks, kBinThreads, g.scatter_smem, st>>>(
      keys, counts, starts, slots, n, g.n_bins, g.group_bins, binner);
}

// L2 policy of a table the test kernels stream once a batch: evict first,
// so that it does not evict the batch's results (1 B a key, stored at
// random, which should leave L2 as whole sectors)
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// Start a 16-byte copy from global to shared memory (cp.async, L2 only,
// under `policy`).
__device__ __forceinline__ void bin_copy_async16(void* dst, const void* src,
                                                 uint64_t policy) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(
          s),
      "l"(src), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bin_copy_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace
