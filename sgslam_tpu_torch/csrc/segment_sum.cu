// Deterministic segment sum (a scatter-add whose order is fixed), for Hopper.
//
//     out[s, c] = init[s, c] + the values[r, c] of the rows r with
//                 index[r] == s, added in a fixed order (below)
//
// It takes the place of every float scatter-add of the port
// (`index_add_`, `index_put_(accumulate=True)`), whose CUDA versions add
// through atomics in an order that changes from launch to launch, so that a
// whole SLAM run on the card did not repeat itself. The reference's sums are
// XLA scatters and dot products (sgslam_tpu/optim/local_ba.py's one-hot
// contraction, pose_graph.py's `.at[].add`), which repeat; no Pallas kernel.
//
// The wrapper (ops/segment.py) sorts the row indices with a stable sort
// (`torch.sort(stable=True)`, CUB's radix sort: deterministic), which gives
// `sorted_idx` [rows] and the permutation `order` [rows]. Rows of one segment
// are then contiguous in sorted order and keep their original order. The
// order of the adds, which the plain version (ops/segment.py's
// `segment_sum_reference`) follows op for op:
//
//   * a segment of at most kLong rows (every segment of the BA and the pose
//     graph): one thread per (segment, column) starts from init and adds
//     the rows one after the other in their original order, the order of
//     the CPU's `index_add_`;
//   * a longer segment (the occupancy grid's voxels near the sensor, which
//     every ray samples; a dense voxel of the point cloud; a camera's
//     observations): one block of kBlock threads per (segment, column).
//     Thread t adds, from zero, the segment's rows t, t + kBlock,
//     t + 2 kBlock, ... (positions within the segment, in order); the kBlock
//     partial sums are then halved kBlock/2, kBlock/4, ..., 1 in shared
//     memory (p[t] = p[t] + p[t + h] for t < h), and p[0] is added to init.
//     So a segment of L rows costs L / kBlock dependent loads, not L.
//
// Kernel 1 (`short_segments`) runs one thread per (sorted row, column); the
// first row of a segment (its head) either sums a short segment or, for
// column 0, appends a long segment's head to a list (slot taken with an
// atomic counter: the list's order varies, each entry's sum does not).
// Kernel 2 (`long_segments`) runs one block per (list entry, column).
//
// values: [rows, cols] float or double, row-major; order, sorted_idx: [rows]
// int64; out: [n, cols], row-major, holding the initial values; work:
// [1 + rows / (kLong + 1)] int64 scratch (a counter, then the list). Indices
// outside [0, n) are dropped (JAX's mode="drop").
//
// What bounds it on an H100 SXM: the bytes. Each value is read once
// (rows * cols * 4), each index twice (sorted and order, 8 bytes each), each
// output read and written once (n * cols * 4 twice) at 3.35 TB/s; there is
// one add per value, which the 67 TFLOP/s of float32 make negligible.
// Adjacent threads take adjacent columns of one row, and a block's threads
// adjacent rows, so index loads coalesce.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kLong = 256;   // longer segments take a block
constexpr int kBlock = 256;      // threads per long segment and column
constexpr int kBatch = 8;        // rows whose loads are issued together
constexpr int kMaxListBlocks = 1024;

template <typename T>
__global__ void short_segments(const T* __restrict__ values,
                               const int64_t* __restrict__ order,
                               const int64_t* __restrict__ sorted_idx,
                               T* __restrict__ out, int64_t rows, int cols,
                               int64_t n, unsigned long long* count,
                               int64_t* heads) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (t >= rows * cols) return;
  const int64_t i = t / cols;
  const int c = static_cast<int>(t - i * cols);
  const int64_t s = sorted_idx[i];
  if (s < 0 || s >= n) return;
  if (i > 0 && sorted_idx[i - 1] == s) return;  // not the segment's head
  if (i + kLong < rows && sorted_idx[i + kLong] == s) {  // > kLong rows
    if (c == 0) heads[atomicAdd(count, 1ULL)] = i;
    return;
  }
  T acc = out[s * cols + c];
  for (int64_t j = i;; j += kBatch) {
    bool ok[kBatch];
    T v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      ok[u] = j + u < rows && sorted_idx[j + u] == s;
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      v[u] = ok[u] ? values[order[j + u] * cols + c] : T(0);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (ok[u]) acc += v[u];
    if (!ok[kBatch - 1]) break;
  }
  out[s * cols + c] = acc;
}

template <typename T>
__global__ void long_segments(const T* __restrict__ values,
                              const int64_t* __restrict__ order,
                              const int64_t* __restrict__ sorted_idx,
                              T* __restrict__ out, int64_t rows, int cols,
                              const unsigned long long* count,
                              const int64_t* heads) {
  __shared__ T part[kBlock];
  const int c = blockIdx.y;
  const int t = threadIdx.x;
  const int64_t entries = static_cast<int64_t>(*count);
  for (int64_t e = blockIdx.x; e < entries; e += gridDim.x) {
    const int64_t head = heads[e];
    const int64_t s = sorted_idx[head];
    T acc = T(0);
    for (int64_t j = head + t;; j += kBatch * kBlock) {
      bool ok[kBatch];
      T v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int64_t jj = j + static_cast<int64_t>(u) * kBlock;
        ok[u] = jj < rows && sorted_idx[jj] == s;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int64_t jj = j + static_cast<int64_t>(u) * kBlock;
        v[u] = ok[u] ? values[order[jj] * cols + c] : T(0);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (ok[u]) acc += v[u];
      if (!ok[kBatch - 1]) break;
    }
    part[t] = acc;
    __syncthreads();
    for (int h = kBlock / 2; h > 0; h >>= 1) {
      if (t < h) part[t] = part[t] + part[t + h];
      __syncthreads();
    }
    if (t == 0) out[s * cols + c] = out[s * cols + c] + part[0];
    __syncthreads();  // part is reused by the next entry
  }
}

template <typename T>
int launch(const void* values, const void* order, const void* sorted_idx,
           void* out, int64_t rows, int cols, int64_t n, void* work,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* count = static_cast<unsigned long long*>(work);
  auto* heads = static_cast<int64_t*>(work) + 1;
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(*count), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = rows * cols;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  short_segments<T><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const T*>(values), static_cast<const int64_t*>(order),
      static_cast<const int64_t*>(sorted_idx), static_cast<T*>(out), rows,
      cols, n, count, heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t most = rows / (kLong + 1);  // segments of > kLong rows
  if (most == 0) return 0;
  const dim3 grid(static_cast<unsigned>(most < kMaxListBlocks
                                            ? most : kMaxListBlocks),
                  static_cast<unsigned>(cols));
  long_segments<T><<<grid, kBlock, 0, st>>>(
      static_cast<const T*>(values), static_cast<const int64_t*>(order),
      static_cast<const int64_t*>(sorted_idx), static_cast<T*>(out), rows,
      cols, count, heads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Each launches on `stream` and returns the
// first CUDA error as an int (0 = launched). The wrapper checks devices,
// dtypes, shapes and contiguity, that rows * cols > 0, that the grid fits
// and that cols <= 65535, and sizes `work`.
extern "C" int sgslam_segment_sum_f32(const void* values, const void* order,
                                      const void* sorted_idx, void* out,
                                      int64_t rows, int cols, int64_t n,
                                      void* work, void* stream) {
  return launch<float>(values, order, sorted_idx, out, rows, cols, n, work,
                       stream);
}

extern "C" int sgslam_segment_sum_f64(const void* values, const void* order,
                                      const void* sorted_idx, void* out,
                                      int64_t rows, int cols, int64_t n,
                                      void* work, void* stream) {
  return launch<double>(values, order, sorted_idx, out, rows, cols, n, work,
                        stream);
}

// The long-segment threshold and block width, for the wrapper's plain
// version and its scratch size.
extern "C" int sgslam_segment_sum_long() { return static_cast<int>(kLong); }
extern "C" int sgslam_segment_sum_block() { return kBlock; }
