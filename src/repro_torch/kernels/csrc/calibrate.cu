// Calibration microbenchmark kernels for Hopper (sm_90a): the machine
// constants of the performance model (perfmodel/calibrate.py).
//
// Replaces the Pallas entry point of repro/perfmodel/calibrate.py:
//   step_kernel   <- measure_step_us's inline `kern` (o = x + 1 on one
//                    (8, 128) u32 block a grid step, grid = (g,))
//
// and runs, as kernels, two probes that the JAX package writes in jnp:
//   chain_kernel  <- measure_gops (a dependent u32 multiply-add chain in a
//                    jitted fori_loop; eager PyTorch would launch once an
//                    iteration and time the launches instead)
//   gather_kernel <- measure_bw_res (jnp.take of random indices from a
//                    small table; on Hopper the resident tier is the L2)
//
// * step_kernel: one CTA of 256 threads a (8, 128) block of 1024 words;
//   each thread loads 16 bytes, adds 1 to each word and stores them. The
//   per-step cost is (t(g) - t(1)) / (g - 1): with g large enough for many
//   full waves of resident CTAs it is the amortised cost of one more CTA,
//   which is what the model multiplies by its schedule vector-ops. Bound:
//   8 KiB of DRAM traffic a CTA (read and write); at the sizes it runs at,
//   launch and CTA scheduling.
// * chain_kernel: one thread a chain a = a * mul + add, started at its
//   index, `iters` dependent steps (a multiple of 16, unrolled by 16); an
//   empty asm with a "+r" operand after each step stops the compiler from
//   folding consecutive steps into one (the product of two affine maps is
//   one affine map). 2 ops a step, as the JAX probe counts them. Bound: the
//   u32 multiply-add rate; a full card of resident warps hides the latency.
// * gather_kernel: thread t sums table[mix32(t + j * n) & mask] over j <
//   per_thread (u32 wrap), the indices made in the kernel from a hash, so
//   no index stream crosses DRAM. 4 useful bytes a gather, as the JAX probe
//   counts them. Bound: L2 sector requests (each gather is one).
//
// C interface for ctypes: each entry point returns cudaGetLastError() after
// its launch (or -1 for arguments it does not take).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockWords = 8 * 128;     // one (8, 128) u32 block
constexpr int kUnroll = 16;

enum Kernel : int { kStep = 0, kChain = 1, kGather = 2 };

__global__ void __launch_bounds__(kThreads)
    step_kernel(const uint4* __restrict__ in, uint4* __restrict__ out) {
  const int64_t i = int64_t(blockIdx.x) * (kBlockWords / 4) + threadIdx.x;
  uint4 v = in[i];
  v.x += 1u;
  v.y += 1u;
  v.z += 1u;
  v.w += 1u;
  out[i] = v;
}

__global__ void __launch_bounds__(kThreads)
    chain_kernel(uint32_t* __restrict__ out, int64_t n, int iters,
                 uint32_t mul, uint32_t add) {
  const int64_t t = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n) return;
  uint32_t a = uint32_t(t);
  for (int i = 0; i < iters; i += kUnroll) {
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      a = a * mul + add;
      asm volatile("" : "+r"(a));
    }
  }
  out[t] = a;
}

// lowbias32 (Wellons): a full-avalanche u32 hash, the plain version's too
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__global__ void __launch_bounds__(kThreads)
    gather_kernel(const uint32_t* __restrict__ table, uint32_t mask,
                  uint32_t* __restrict__ out, int64_t n, int per_thread) {
  const int64_t t = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n) return;
  const uint32_t stride = uint32_t(n);
  uint32_t id = uint32_t(t), acc = 0;
  for (int j = 0; j < per_thread; ++j, id += stride)
    acc += __ldg(table + (mix32(id) & mask));
  out[t] = acc;
}

unsigned grid_for(int64_t n) { return unsigned((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// in, out: (8 g, 128) int32, 16-byte aligned; one CTA a (8, 128) block.
int calibrate_step(const void* in, void* out, long long g, void* stream) {
  if (g <= 0 || g > 0x7fffffffLL) return -1;
  step_kernel<<<unsigned(g), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(in), static_cast<uint4*>(out));
  return int(cudaGetLastError());
}

// out: (n,) int32; iters a positive multiple of 16.
int calibrate_chain(void* out, long long n, int iters, unsigned mul,
                    unsigned add, void* stream) {
  if (n <= 0 || iters <= 0 || iters % kUnroll) return -1;
  chain_kernel<<<grid_for(n), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), n, iters, mul, add);
  return int(cudaGetLastError());
}

// table: (mask + 1,) int32, mask + 1 a power of two; out: (n,) int32;
// n * per_thread <= 2^32 (the hashed ids stay distinct).
int calibrate_gather(const void* table, unsigned mask, void* out,
                     long long n, int per_thread, void* stream) {
  if (n <= 0 || per_thread <= 0 ||
      (unsigned long long)n * (unsigned long long)per_thread > (1ULL << 32))
    return -1;
  gather_kernel<<<grid_for(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(table), mask,
      static_cast<uint32_t*>(out), n, per_thread);
  return int(cudaGetLastError());
}

// CTAs of kernel `which` (0 step, 1 chain, 2 gather) resident on one SM of
// the current device at 256 threads; -1 on error.
int calibrate_blocks_per_sm(int which) {
  int blocks = -1;
  cudaError_t err = cudaErrorInvalidValue;
  if (which == kStep)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, step_kernel,
                                                        kThreads, 0);
  else if (which == kChain)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, chain_kernel,
                                                        kThreads, 0);
  else if (which == kGather)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks,
                                                        gather_kernel,
                                                        kThreads, 0);
  return err == cudaSuccess ? blocks : -1;
}

}  // extern "C"
