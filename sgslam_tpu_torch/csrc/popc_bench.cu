// Microbenchmark: the card's 32-bit population-count issue rate.
//
// K1 (hamming.cu) is bound by popc issue, not by memory, so its bound is
// only as good as the popc rate it is reckoned with. This kernel measures
// that rate: every thread keeps kChains independent chains, and each step
// of a chain is one POPC and two integer adds (the chain's operand steps by
// an odd constant, and its sum takes the count), so the adds, at four times
// the popc rate of the integer pipes, never limit it. The sums are written
// out, so no step can be dropped. chip_smoke.py launches it with enough
// blocks to fill every SM and times it between CUDA events:
//
//     rate = threads * iters * kChains / seconds      (popc per second)

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChains = 8;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
popc_bench_kernel(unsigned* __restrict__ out, int iters) {
  const unsigned tid = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned x[kChains], s[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) {
    x[k] = tid * 2654435761u + k * 40503u;
    s[k] = 0;
  }
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      s[k] += __popc(x[k]);
      x[k] += 0x9E3779B9u;
    }
  }
  unsigned total = 0;
#pragma unroll
  for (int k = 0; k < kChains; ++k) total += s[k];
  out[tid] = total;
}

}  // namespace

extern "C" int sgslam_popc_bench_chains() { return kChains; }

extern "C" int sgslam_popc_bench_threads() { return kThreads; }

// Plain C entry point for ctypes: `blocks` blocks of kThreads threads, each
// thread doing iters * kChains popc, on `stream`; `out` holds
// blocks * kThreads uint32. Returns cudaGetLastError() (0 = launched).
extern "C" int sgslam_popc_bench(void* out, int blocks, int iters,
                                 void* stream) {
  popc_bench_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}
