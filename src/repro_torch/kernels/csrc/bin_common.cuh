// The stages the binned kernels of cbf.cu (the classical add and contains)
// and counting.cu (the counting update) share: a chunk's key range, each
// bin's per-chunk runs padded to whole 32-byte sectors, and the scan of the
// bins' lengths into their slices of the slot workspace. Everything sits in
// an anonymous namespace, so each library that includes it gets its own
// copy.

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

}  // namespace
