// 256-bit Hamming distance matrix for packed ORB descriptors, for Hopper.
//
// Replaces the TPU kernel `_hamming_kernel` / `hamming_matrix_pallas`
// (sgslam_tpu/ops/pallas_hamming.py), which tiles the output into 128x128
// VMEM blocks over word-major, 128-padded inputs:
//
//     out[i, j] = sum_{w < 8} popcount(a[i, w] ^ b[j, w])
//
// a: [n, 8] int32, b: [m, 8] int32 (the uint32 words, bit-cast), row-major,
// 32 bytes per descriptor, no padding; out: [n, m] int32, row-major.
//
// What bounds it on an H100 SXM at 4096 x 1024:
//   * bytes: the int32 output is 4096 * 1024 * 4 = 16.8 MB; the inputs add
//     0.16 MB. At 3.35 TB/s that is about 5.06 us.
//   * operations: by the route the card runs fastest, |a| + |b| -
//     2 <bits_a, bits_b> on the tensor cores (the JAX package's
//     `hamming_matrix_mxu`), 2 * 4096 * 1024 * 256 int8 operations at
//     1,979 TOP/s, 1.09 us. This kernel's own route, 33.5 M popc at the
//     documented 16 per clock per SM, takes 8.0 us.
//   So the output's bytes bound it (ops/hamming_cuda.hamming_bound).
//
// Measured on an H100 SXM (700 W) by chip_smoke.py: 11.2 us per call at
// 4096 x 1024 (CUDA-graph replay), 45% of that bound. No search of the
// port runs it since the fused search (csrc/hamming_search.cu) took its
// place; it stays as the counterpart of `_hamming_kernel`.
//
// Design: a block of 32 x 8 threads owns a 64-row x 128-column output
// tile. The tile's 64 A descriptors are staged once in shared memory and
// read back as warp-wide broadcasts (all lanes of a warp share a row). Each
// thread keeps its 4 B descriptors (4 columns, 32 apart) in registers for
// the whole tile, so B is read from device memory once per tile. A warp's
// 32 lanes own 32 consecutive columns, so every store of the [n, m] output
// writes 128 contiguous bytes. Ragged edges are masked: A rows past n are
// zero in shared memory and never stored; B columns past m are never
// loaded or stored. No wgmma/TMA: the work is integer popcounts.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;
constexpr int kThreadsX = 32;               // lanes -> columns
constexpr int kThreadsY = 8;                // warps -> rows
constexpr int kColsPerThread = 4;
constexpr int kRowsPerThread = 8;
constexpr int kTileCols = kThreadsX * kColsPerThread;   // 128
constexpr int kTileRows = kThreadsY * kRowsPerThread;   // 64

__global__ void __launch_bounds__(kThreadsX * kThreadsY)
hamming_kernel(const int4* __restrict__ a, const int4* __restrict__ b,
               int* __restrict__ out, int n, int m) {
  __shared__ int4 a_tile[kTileRows][2];     // 64 descriptors x 32 bytes

  const int row0 = blockIdx.y * kTileRows;
  const int col0 = blockIdx.x * kTileCols;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;

  // Stage the tile's A descriptors: 128 int4 loads, one per thread.
  if (tid < kTileRows * 2) {
    const int r = tid >> 1;
    const int half = tid & 1;
    const int gr = row0 + r;
    a_tile[r][half] = gr < n ? a[gr * 2 + half] : make_int4(0, 0, 0, 0);
  }

  // This thread's B descriptors stay in registers.
  uint32_t bw[kColsPerThread][kWords];
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) {
    const int c = col0 + tx + j * kThreadsX;
    int4 lo = make_int4(0, 0, 0, 0), hi = lo;
    if (c < m) {
      lo = b[c * 2];
      hi = b[c * 2 + 1];
    }
    bw[j][0] = lo.x; bw[j][1] = lo.y; bw[j][2] = lo.z; bw[j][3] = lo.w;
    bw[j][4] = hi.x; bw[j][5] = hi.y; bw[j][6] = hi.z; bw[j][7] = hi.w;
  }
  __syncthreads();

#pragma unroll 2
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = ty + i * kThreadsY;
    const int gr = row0 + r;
    if (gr >= n) break;
    const int4 lo = a_tile[r][0];
    const int4 hi = a_tile[r][1];
    const uint32_t aw[kWords] = {
        (uint32_t)lo.x, (uint32_t)lo.y, (uint32_t)lo.z, (uint32_t)lo.w,
        (uint32_t)hi.x, (uint32_t)hi.y, (uint32_t)hi.z, (uint32_t)hi.w};
    int* out_row = out + (size_t)gr * m;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int c = col0 + tx + j * kThreadsX;
      int acc = 0;
#pragma unroll
      for (int w = 0; w < kWords; ++w) acc += __popc(aw[w] ^ bw[j][w]);
      if (c < m) out_row[c] = acc;
    }
  }
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream` and returns
// cudaGetLastError() as an int (0 = launched). Pointers must be 16-byte
// aligned; the Python wrapper checks that, and that n, m > 0.
extern "C" int sgslam_hamming_matrix(const void* a, const void* b, void* out,
                                     int n, int m, void* stream) {
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((m + kTileCols - 1) / kTileCols,
                  (n + kTileRows - 1) / kTileRows);
  hamming_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(a), static_cast<const int4*>(b),
      static_cast<int*>(out), n, m);
  return static_cast<int>(cudaGetLastError());
}
