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
// The order of the adds, which the plain version (ops/segment.py's
// `segment_sum_reference`) follows op for op:
//
//   * a segment of at most kLong rows (every segment of the BA and the pose
//     graph): from init (or zero), the rows one after the other in their
//     original order, the order of the CPU's `index_add_`;
//   * a longer segment (the occupancy grid's voxels near the sensor, which
//     every ray samples; a dense voxel of the point cloud; a camera's
//     observations): partial sum t (t < kBlock) adds, from zero, the
//     segment's rows t, t + kBlock, t + 2 kBlock, ... (positions within the
//     segment, in order); the kBlock partial sums are halved kBlock/2,
//     kBlock/4, ..., 1 (p[t] = p[t] + p[t + h] for t < h), and p[0] is
//     added to init (or zero).
// Rows whose index lies outside [0, n) are dropped (JAX's mode="drop").
//
// One call, on the caller's stream:
//
//   1. a memset of the sort's counters, then `histogram`: the key of row r
//      is index[r] if it lies in [0, n), else n (a dropped row); the kernel
//      counts the kept rows and their keys' 8-bit digits for every pass.
//   2. `sort_pass`, once per 8 bits of the keys' ceil(log2(n)) (3 passes
//      for the BA's window, the occupancy grid and the global BA, where the
//      64-bit `torch.sort` of the parent made 8): an LSD radix pass in the
//      manner of Merrill and Garland's onesweep. Each block takes a tile of
//      2048 rows in ticket order, ranks them by digit (warp by warp, with
//      __match_any_sync, so equal digits keep their row order), learns the
//      digit totals of the tiles before it by a decoupled look-back, and
//      writes its rows out digit by digit. Every pass keeps equal keys in
//      row order, so the sort is stable. The first pass writes only the
//      kept rows (85-92% of the rows of the occupancy and BA sums are
//      dropped), and the later passes sort only those, their count read on
//      the device. The payload is the row id, or for cols == 1 the value
//      itself, so that the sum reads values in sorted order and gathers
//      nothing. Small tiles spread the BA's 24576 rows over 12 SMs: CUB's
//      device sort, whose pass at that size is one large tile's time on
//      one SM plus a memset, took ~9 us a pass there.
//   3. `sum_rows`: block b owns output rows [b S, b S + S) (S chosen so
//      that a block writes about kStores values and sums about kGathers).
//      Two warps find its range of sorted positions by a 32-ary search;
//      the block marks where each row's run starts and stops in shared
//      memory, writes init (or zero) over its rows with 16-byte stores
//      (skipping the rows of long runs), then, one thread per (run,
//      column), init plus each short run's rows, in order. Block b also
//      owns the long runs that start in its b-th share of the sorted
//      positions, so that the long runs near the sensor, which share a few
//      output blocks, spread over the grid: a warp sums one (run, column)
//      with lane l holding partial sums l, l + 32, ..., l + 224 and the
//      tree in registers and shuffles; a run of kBigLong rows or more takes
//      the whole block. There is no output pre-pass (zeros, clone) and no
//      second grid.
//
// What bounds it on an H100 SXM: the bytes (3.35 TB/s), one add per value
// (67 TFLOP/s float32, negligible). The sort reads and writes 8 bytes (12
// for a double payload) per kept row and pass (the first reads every
// row's index); the sum reads the kept rows' keys, payloads and values once
// and writes each output (reading init) once, a row with a run twice.
// Adjacent threads take adjacent columns of one row, or adjacent runs, so
// the gathers of `values` coalesce along a row.
//
// The wrapper sizes the scratch (`sgslam_segment_sum_scratch`) and
// allocates it and the output as torch tensors, so CUDA-graph capture works.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLong = 256;      // longer segments are summed in a tree
constexpr int kBlock = 256;     // partial sums of a long segment
constexpr int kBatch = 8;       // loads issued together
constexpr int kMaxRows = 1024;  // output rows of a block, at most
constexpr int kStores = 32768;  // values a block aims to write
constexpr int kGathers = 2048;  // and to sum
constexpr int kChunk = 8;       // columns a block's long sum takes at once
constexpr int kMaxLong = 256;   // long runs starting in a block's positions
constexpr int64_t kMaxPositions = (kMaxLong - 1) * int64_t{kLong + 1};
constexpr int kBigLong = 4096;  // longer runs take the whole block
constexpr int kBins = 256;      // 8-bit digits
constexpr int kMaxPasses = 4;
constexpr int kTileItems = 8;  // rows a thread takes in a sort tile
constexpr int kTile = kThreads * kTileItems;
constexpr int kHistBlocks = 1056;  // 8 per SM of an H100 SXM's 132
constexpr unsigned kAggregate = 1u << 30, kPrefix = 2u << 30;
constexpr unsigned kCountMask = kAggregate - 1;
constexpr size_t kAlign = 256;
static_assert(kBlock == kThreads && kBins == kThreads,
              "a long segment's partial sums and the digits are the "
              "block's threads");

size_t aligned(size_t bytes) { return (bytes + kAlign - 1) / kAlign * kAlign; }

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
};
template <>
struct Vec<double> {
  using type = double2;
};

template <typename I>
__device__ __forceinline__ uint32_t key_of(const I* __restrict__ index,
                                           int64_t r, uint32_t n) {
  const int64_t s = static_cast<int64_t>(index[r]);
  return (s >= 0 && s < static_cast<int64_t>(n)) ? static_cast<uint32_t>(s)
                                                 : n;
}

// Scan of v over the block's kThreads threads, in thread order;
// `warp_sums` holds kWarps ints of shared memory. Returns the sum of v over
// the threads before this one; `total` gets the sum over all.
__device__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += warp_sums[w];
    all += warp_sums[w];
  }
  __syncthreads();  // warp_sums may be reused
  *total = all;
  return before + x - v;
}

// The kept rows (index in [0, n)) and the digit counts of their keys for
// every pass (the global bases of the digits); the block counts in shared
// memory, a warp's equal digits added once.
template <typename I>
__global__ void __launch_bounds__(kThreads)
    histogram(const I* __restrict__ index, int64_t rows, uint32_t n,
              int passes, unsigned* __restrict__ hist,
              unsigned* __restrict__ kept) {
  __shared__ unsigned counts[kMaxPasses][kBins];
  __shared__ unsigned block_kept;
  const int t = threadIdx.x, lane = t & 31;
  for (int i = t; i < kMaxPasses * kBins; i += kThreads)
    (&counts[0][0])[i] = 0;
  if (t == 0) block_kept = 0;
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads;
       base < rows; base += stride) {
    const int64_t r = base + t;
    const uint32_t key = r < rows ? key_of(index, r, n) : n;
    const bool keep = key < n;
    const unsigned keepers = __ballot_sync(0xffffffffu, keep);
    if (keepers == 0u) continue;
    if (lane == 0)
      atomicAdd(&block_kept, static_cast<unsigned>(__popc(keepers)));
    for (int p = 0; p < passes; ++p) {
      const uint32_t d = keep ? (key >> (8 * p)) & 0xffu : 0x100u;
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      if (keep && lane == 31 - __clz(peers))
        atomicAdd(&counts[p][d], static_cast<unsigned>(__popc(peers)));
    }
  }
  __syncthreads();
  for (int i = t; i < passes * kBins; i += kThreads) {
    const unsigned c = (&counts[0][0])[i];
    if (c) atomicAdd(hist + i, c);
  }
  if (t == 0 && block_kept) atomicAdd(kept, block_kept);
}

// One LSD pass over the digit (key >> shift) & 255: rows in, sorted by that
// digit, equal digits in their incoming order, out. The first pass reads
// the keys of all `rows` from `index`, takes the payload from `pay_in`
// (the values) or, when it is null, the row id, and writes out only the
// kept rows; the later passes sort the `*kept` rows of the buffers.
template <typename I, typename P>
__global__ void __launch_bounds__(kThreads)
    sort_pass(const I* __restrict__ index, uint32_t n,
              const uint32_t* __restrict__ keys_in,
              const P* __restrict__ pay_in, uint32_t* __restrict__ keys_out,
              P* __restrict__ pay_out, int rows,
              const unsigned* __restrict__ kept, int shift,
              const unsigned* __restrict__ hist, unsigned* ticket,
              unsigned* lookback) {
  __shared__ uint32_t s_keys[kTile];
  __shared__ P s_pay[kTile];
  __shared__ int warp_counts[kWarps][kBins];
  __shared__ int tile_start[kBins];
  __shared__ int64_t out_base[kBins];
  __shared__ int warp_sums[kWarps];
  __shared__ int s_tile;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool first = index != nullptr;
  const int items = first ? rows : static_cast<int>(*kept);
  if (t == 0) s_tile = static_cast<int>(atomicAdd(ticket, 1u));
  for (int i = t; i < kWarps * kBins; i += kThreads)
    (&warp_counts[0][0])[i] = 0;
  __syncthreads();
  const int tile = s_tile;
  if (tile * kTile >= items) return;  // past the kept rows: no work
  const int base = tile * kTile + warp * (kTile / kWarps);

  // load: warp w takes rows [base, base + 256), 32 a round, in order
  uint32_t key[kTileItems];
  P pay[kTileItems];
  int rank[kTileItems];
#pragma unroll
  for (int u = 0; u < kTileItems; ++u) {
    const int r = base + u * 32 + lane;
    key[u] = n;
    pay[u] = P(0);
    if (r < items) {
      if (first) {
        key[u] = key_of(index, r, n);
        if (key[u] < n)
          pay[u] = pay_in != nullptr ? pay_in[r] : static_cast<P>(r);
      } else {
        key[u] = keys_in[r];
        pay[u] = pay_in[r];
      }
    }
  }
  // rank within the warp: earlier rounds, then lower lanes, go first
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int u = 0; u < kTileItems; ++u) {
    const bool ok = key[u] < n;
    rank[u] = 0;
    if (__ballot_sync(0xffffffffu, ok) == 0u) continue;  // all dropped
    const uint32_t d = ok ? (key[u] >> shift) & 0xffu : 0x100u;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (ok) rank[u] = warp_counts[warp][d] + __popc(peers & lower);
    __syncwarp();
    if (ok && lane == 31 - __clz(peers)) warp_counts[warp][d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // thread d: the digit's count in each warp -> the warps' offsets, the
  // tile's count, the tile's start of the digit and the digit's base
  const int d = t;
  int count = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_counts[w][d];
    warp_counts[w][d] = count;
    count += c;
  }
  int in_tile = 0, all = 0;
  tile_start[d] = block_exclusive_scan(count, warp_sums, &in_tile);
  const int digit_base =
      block_exclusive_scan(static_cast<int>(hist[d]), warp_sums, &all);
  // decoupled look-back over the tiles before this one
  volatile unsigned* mine = lookback + static_cast<int64_t>(tile) * kBins + d;
  unsigned before = 0;
  if (tile == 0) {
    *mine = kPrefix | static_cast<unsigned>(count);
  } else {
    *mine = kAggregate | static_cast<unsigned>(count);
    for (int p = tile - 1; p >= 0;) {
      const unsigned v = *static_cast<volatile unsigned*>(
          lookback + static_cast<int64_t>(p) * kBins + d);
      if ((v & ~kCountMask) == 0) continue;  // not published yet
      before += v & kCountMask;
      if (v & kPrefix) break;
      --p;
    }
    *mine = kPrefix | (before + static_cast<unsigned>(count));
  }
  out_base[d] = static_cast<int64_t>(digit_base) + before;
  __syncthreads();

  // the tile in digit order in shared memory, then out, digit run by run
#pragma unroll
  for (int u = 0; u < kTileItems; ++u) {
    if (key[u] < n) {
      const int dd = (key[u] >> shift) & 0xffu;
      const int at = tile_start[dd] + warp_counts[warp][dd] + rank[u];
      s_keys[at] = key[u];
      s_pay[at] = pay[u];
    }
  }
  __syncthreads();
  for (int i = t; i < in_tile; i += kThreads) {
    const uint32_t k = s_keys[i];
    const int dd = (k >> shift) & 0xffu;
    const int64_t at = out_base[dd] + (i - tile_start[dd]);
    keys_out[at] = k;
    pay_out[at] = s_pay[i];
  }
}

// The first position p in [lo, hi) with keys[p] >= target (hi if none),
// keys sorted; called by a whole warp, which probes 32 positions a round.
__device__ int64_t lower_bound_warp(const uint32_t* __restrict__ keys,
                                    int64_t lo, int64_t hi, uint32_t target) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {  // the answer lies in [lo, hi]
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t q = lo + (lane + 1) * step - 1;
    const bool less = q < hi && keys[q] < target;
    const int cnt = __popc(__ballot_sync(0xffffffffu, less));
    const int64_t qc = lo + (cnt + 1) * step - 1;  // keys[qc] >= target
    if (cnt < 32 && qc < hi) hi = qc;
    lo += cnt * step;
  }
  return lo;
}

template <typename T, bool kDirect>
__device__ __forceinline__ T load(const T* __restrict__ values,
                                  const void* __restrict__ payload, int j,
                                  int cols, int c) {
  if (kDirect) return static_cast<const T*>(payload)[j];
  const int64_t r = static_cast<const uint32_t*>(payload)[j];
  return values[r * cols + c];
}

// The tree sum of column c of the run [a, e), by one warp: lane l holds
// partial sums l + 32 i (i < 8); the halvings by 128, 64 and 32 stay in a
// lane, the rest go through shuffles. Lane 0 returns p[0].
template <typename T, bool kDirect>
__device__ T warp_tree(const T* __restrict__ values,
                       const void* __restrict__ payload, int a, int e,
                       int cols, int c) {
  const int lane = threadIdx.x & 31;
  T acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = T(0);
  for (int j = a + lane; j < e; j += kBlock) {
    T v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = j + 32 * i < e
                 ? load<T, kDirect>(values, payload, j + 32 * i, cols, c)
                 : T(0);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (j + 32 * i < e) acc[i] += v[i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = acc[i] + acc[i + 4];
#pragma unroll
  for (int i = 0; i < 2; ++i) acc[i] = acc[i] + acc[i + 2];
  acc[0] = acc[0] + acc[1];
#pragma unroll
  for (int h = 16; h > 0; h >>= 1) {
    const T o = __shfl_down_sync(0xffffffffu, acc[0], h);
    if (lane < h) acc[0] = acc[0] + o;
  }
  return acc[0];
}

// out[from, to) = init[from, to), or zero: 16-byte stores where the
// addresses allow, by the whole block.
template <typename T>
__device__ void fill(T* __restrict__ out, const T* __restrict__ init,
                     int64_t from, int64_t to, bool vector_init) {
  using V = typename Vec<T>::type;
  constexpr int kVec = sizeof(V) / sizeof(T);
  const int t = threadIdx.x;
  int64_t body = (from + kVec - 1) / kVec * kVec;
  int64_t tail = to / kVec * kVec;
  if (body > tail || (init != nullptr && !vector_init)) body = tail = to;
  for (int64_t i = from + t; i < body; i += kThreads)
    out[i] = init != nullptr ? init[i] : T(0);
  for (int64_t v = body / kVec + t; v < tail / kVec; v += kThreads)
    reinterpret_cast<V*>(out)[v] =
        init != nullptr ? reinterpret_cast<const V*>(init)[v] : V{};
  for (int64_t i = (tail > body ? tail : body) + t; i < to; i += kThreads)
    out[i] = init != nullptr ? init[i] : T(0);
}

// kDirect: cols == 1 and the sorted payload holds the values themselves.
template <typename T, bool kDirect>
__global__ void __launch_bounds__(kThreads)
    sum_rows(const T* __restrict__ values, const uint32_t* __restrict__ keys,
             const void* __restrict__ payload, const T* __restrict__ init,
             T* __restrict__ out, const unsigned* __restrict__ kept,
             int cols, int64_t n, int per_block) {
  __shared__ int start[kMaxRows];
  __shared__ int stop[kMaxRows];
  __shared__ int heads[kMaxRows];       // rows with a short run
  __shared__ int long_rows[kMaxRows];   // rows with a long run, in order
  __shared__ unsigned long_mask[kMaxRows / 32];
  __shared__ int long_at[kMaxLong];
  __shared__ int long_end[kMaxLong];
  __shared__ T part[kDirect ? 1 : kChunk][kBlock];
  __shared__ int64_t range[2];
  __shared__ int n_heads, n_long_rows, n_long;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * per_block;
  const int rows_here =
      s0 >= n ? 0 : static_cast<int>(n - s0 < per_block ? n - s0 : per_block);
  const int64_t sorted = *kept;  // the sorted rows: the kept ones

  if (t < 64 && rows_here > 0) {
    const int64_t p = lower_bound_warp(
        keys, 0, sorted,
        static_cast<uint32_t>(s0 + (t < 32 ? 0 : rows_here)));
    if (lane == 0) range[warp] = p;
  }
  if (t < kMaxRows / 32) long_mask[t] = 0u;
  if (t == 0) n_heads = n_long = 0;
  __syncthreads();
  const int p0 = rows_here > 0 ? static_cast<int>(range[0]) : 0;
  const int p1 = rows_here > 0 ? static_cast<int>(range[1]) : 0;

  // this block's rows: the runs in [p0, p1), where each starts and stops,
  // and whether it is long
  for (int p = p0 + t; p < p1; p += kBatch * kThreads) {
    uint32_t key[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int q = p + u * kThreads;
      key[u] = q < p1 ? keys[q] : 0u;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int q = p + u * kThreads;
      if (q >= p1) break;
      const int k = static_cast<int>(key[u] - s0);
      if (q == p0 || keys[q - 1] != key[u]) {
        start[k] = q;
        if (q + kLong < p1 && keys[q + kLong] == key[u])
          atomicOr(&long_mask[k >> 5], 1u << (k & 31));
        else
          heads[atomicAdd(&n_heads, 1)] = k;
      }
      if (q + 1 == p1 || keys[q + 1] != key[u]) stop[k] = q + 1;
    }
  }
  // this block's share of the positions (at most kMaxPositions, as the
  // wrapper sizes the grid): the long runs that start there
  const int64_t share = (sorted + gridDim.x - 1) / gridDim.x;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * share;
  const int64_t q1 = q0 + share < sorted ? q0 + share : sorted;
  for (int64_t q = q0 + t; q < q1; q += kThreads) {
    const uint32_t key = keys[q];
    if ((q == 0 || keys[q - 1] != key) && q + kLong < sorted &&
        keys[q + kLong] == key)
      long_at[atomicAdd(&n_long, 1)] = static_cast<int>(q);
  }
  __syncthreads();
  // the rows with a long run, in order (their block of the long runs
  // writes them)
  if (warp == 0) {
    const unsigned m = long_mask[lane];
    int before = __popc(m);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, before, o);
      if (lane >= o) before += y;
    }
    if (lane == 31) n_long_rows = before;
    before -= __popc(m);
    for (unsigned b = m; b; b &= b - 1)
      long_rows[before++] = lane * 32 + __ffs(b) - 1;
  }
  __syncthreads();

  // every other row: init (or zero), with wide stores
  const bool vector_init =
      init == nullptr || reinterpret_cast<uintptr_t>(init) % 16 == 0;
  int from = 0;
  for (int i = 0; i <= n_long_rows; ++i) {
    const int to = i < n_long_rows ? long_rows[i] : rows_here;
    fill(out, init, (s0 + from) * cols, (s0 + to) * cols, vector_init);
    from = to + 1;
  }
  __syncthreads();

  // the rows with a short run: init plus the run, row by row. A warp takes
  // 32 / cols runs (cols <= 32) or one run 32 columns at a time, so that
  // its stores are contiguous.
  const int lanes = cols < 32 ? cols : 32;
  const int per_warp = 32 / lanes;
  const int sub = lane / lanes;
  const int c_lane = lane - sub * lanes;
  const int runs = n_heads;
  if (sub < per_warp) {
    for (int h = warp * per_warp + sub; h < runs; h += kWarps * per_warp) {
      const int k = heads[h];
      const int a = start[k], e = stop[k];
      const int64_t row = (s0 + k) * cols;
      for (int c = c_lane; c < cols; c += lanes) {
        const int64_t o = row + c;
        T acc = init != nullptr ? init[o] : T(0);
        for (int j = a; j < e; j += kBatch) {
          T v[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            v[u] = j + u < e
                       ? load<T, kDirect>(values, payload, j + u, cols, c)
                       : T(0);
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            if (j + u < e) acc += v[u];
        }
        out[o] = acc;
      }
    }
  }

  // the long runs: where each stops
  const int longs = n_long;
  for (int i = warp; i < longs; i += kWarps) {
    const int a = long_at[i];
    const int64_t e =
        lower_bound_warp(keys, a + kLong + 1, sorted, keys[a] + 1u);
    if (lane == 0) long_end[i] = static_cast<int>(e);
  }
  __syncthreads();
  // runs of kBigLong rows or more: the whole block, kChunk columns at once
  constexpr int kCols = kDirect ? 1 : kChunk;
  constexpr int kRowsAtOnce = kDirect ? kBatch : 2;
  for (int i = 0; i < longs; ++i) {
    const int a = long_at[i], e = long_end[i];
    if (e - a < kBigLong) continue;
    const int64_t row = keys[a];
    for (int c0 = 0; c0 < cols; c0 += kCols) {
      const int nc = cols - c0 < kCols ? cols - c0 : kCols;
      T acc[kCols];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) acc[cc] = T(0);
      for (int j = a + t; j < e; j += kRowsAtOnce * kBlock) {
        T v[kRowsAtOnce][kCols];
#pragma unroll
        for (int u = 0; u < kRowsAtOnce; ++u) {
          const int jj = j + u * kBlock;
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc)
            v[u][cc] = jj < e && cc < nc
                           ? load<T, kDirect>(values, payload, jj, cols,
                                              c0 + cc)
                           : T(0);
        }
#pragma unroll
        for (int u = 0; u < kRowsAtOnce; ++u) {
          if (j + u * kBlock >= e) break;
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) acc[cc] += v[u][cc];
        }
      }
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) part[cc][t] = acc[cc];
      __syncthreads();
      for (int h = kBlock / 2; h > 0; h >>= 1) {
        for (int q = t; q < h * nc; q += kThreads) {
          const int cc = q / h;
          const int u = q - cc * h;
          part[cc][u] = part[cc][u] + part[cc][u + h];
        }
        __syncthreads();
      }
      if (t < nc) {
        const int64_t o = row * cols + c0 + t;
        out[o] = (init != nullptr ? init[o] : T(0)) + part[t][0];
      }
      __syncthreads();  // part is reused by the next chunk
    }
  }
  // shorter long runs: a warp per (run, column)
  for (int it = warp; it < longs * cols; it += kWarps) {
    const int i = it / cols;
    const int c = it - i * cols;
    const int a = long_at[i], e = long_end[i];
    if (e - a >= kBigLong) continue;
    const T sum = warp_tree<T, kDirect>(values, payload, a, e, cols, c);
    if (lane == 0) {
      const int64_t o = static_cast<int64_t>(keys[a]) * cols + c;
      out[o] = (init != nullptr ? init[o] : T(0)) + sum;
    }
  }
}

int passes_of(int bits) { return (bits + 7) / 8; }

int64_t tiles_of(int64_t rows) { return (rows + kTile - 1) / kTile; }

// Output rows per block: about kStores values written and kGathers values
// summed (if every row were kept), at most kMaxRows.
int rows_per_block(int64_t rows, int cols, int64_t n) {
  const double stores = static_cast<double>(kStores) / cols;
  const double gathers =
      kGathers / (cols * (static_cast<double>(rows) / n));
  const double s = stores < gathers ? stores : gathers;
  return s < 1.0 ? 1 : (s > kMaxRows ? kMaxRows : static_cast<int>(s));
}

// The scratch: the counters (digit counts, tickets, the kept rows, the
// look-back words; zeroed by one memset), then two buffers each of keys
// and payloads.
struct Scratch {
  unsigned* counters;
  size_t counter_bytes;
  uint32_t* keys[2];
  void* pay[2];
  size_t bytes;
};

Scratch carve(void* base, int64_t rows, int bits, size_t pay_bytes) {
  const int passes = passes_of(bits);
  Scratch s;
  s.counter_bytes = aligned(sizeof(unsigned) *
                            (kMaxPasses * kBins + kMaxPasses + 1 +
                             passes * tiles_of(rows) * kBins));
  char* p = static_cast<char*>(base);
  s.counters = reinterpret_cast<unsigned*>(p);
  p += s.counter_bytes;
  for (int b = 0; b < 2; ++b) {
    s.keys[b] = reinterpret_cast<uint32_t*>(p);
    p += aligned(rows * sizeof(uint32_t));
  }
  for (int b = 0; b < 2; ++b) {
    s.pay[b] = p;
    p += aligned(rows * pay_bytes);
  }
  s.bytes = p - static_cast<char*>(base);
  return s;
}

template <typename T, typename P, typename I>
int launch(const void* values_ptr, const void* index_ptr, const void* init,
           void* out, int64_t rows, int cols, int64_t n, int bits,
           void* scratch, size_t scratch_size, cudaStream_t st) {
  const bool direct = sizeof(P) == sizeof(T) && cols == 1;
  const Scratch s = carve(scratch, rows, bits, sizeof(P));
  if (s.bytes > scratch_size) return static_cast<int>(cudaErrorInvalidValue);
  const T* values = static_cast<const T*>(values_ptr);
  const I* index = static_cast<const I*>(index_ptr);
  const int passes = passes_of(bits);
  const int64_t tiles = tiles_of(rows);
  unsigned* hist = s.counters;
  unsigned* tickets = hist + kMaxPasses * kBins;
  unsigned* kept = tickets + kMaxPasses;
  unsigned* lookback = kept + 1;

  cudaError_t err = cudaMemsetAsync(s.counters, 0, s.counter_bytes, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t want = (rows + kThreads - 1) / kThreads;
  histogram<I><<<static_cast<unsigned>(want < kHistBlocks ? want
                                                          : kHistBlocks),
                 kThreads, 0, st>>>(index, rows, static_cast<uint32_t>(n),
                                    passes, hist, kept);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int p = 0; p < passes; ++p) {
    const int src = (p + 1) & 1, dst = p & 1;
    sort_pass<I, P><<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
        p == 0 ? index : nullptr, static_cast<uint32_t>(n),
        s.keys[src],
        p == 0 ? (direct ? reinterpret_cast<const P*>(values) : nullptr)
               : static_cast<const P*>(s.pay[src]),
        s.keys[dst], static_cast<P*>(s.pay[dst]), static_cast<int>(rows),
        kept, 8 * p, hist + p * kBins, tickets + p,
        lookback + p * tiles * kBins);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const uint32_t* keys = s.keys[(passes - 1) & 1];
  const void* payload = s.pay[(passes - 1) & 1];

  // enough blocks for each one's share of the sorted positions to hold at
  // most kMaxPositions (so at most kMaxLong long runs start in it)
  const int per_block = rows_per_block(rows, cols, n);
  int64_t blocks = (n + per_block - 1) / per_block;
  const int64_t by_pos = (rows + kMaxPositions - 1) / kMaxPositions;
  if (blocks < by_pos) blocks = by_pos;
  if (direct)
    sum_rows<T, true><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        values, keys, payload, static_cast<const T*>(init),
        static_cast<T*>(out), kept, cols, n, per_block);
  else
    sum_rows<T, false><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        values, keys, payload, static_cast<const T*>(init),
        static_cast<T*>(out), kept, cols, n, per_block);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int launch_index(const void* values, const void* index, int index_bytes,
                 const void* init, void* out, int64_t rows, int cols,
                 int64_t n, int bits, void* scratch, int64_t scratch_size,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t size = static_cast<size_t>(scratch_size);
  return index_bytes == 8
             ? launch<T, P, int64_t>(values, index, init, out, rows, cols, n,
                                     bits, scratch, size, st)
             : launch<T, P, int32_t>(values, index, init, out, rows, cols, n,
                                     bits, scratch, size, st);
}

int set_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return static_cast<int>(err);
}

bool args_ok(int64_t rows, int64_t cols, int64_t n, int bits) {
  return rows >= 1 && rows < (int64_t{1} << 30) && cols >= 1 &&
         cols <= 65535 && n >= 1 && bits >= 1 &&
         bits <= 8 * kMaxPasses && ((n - 1) >> bits) == 0 &&
         n < (int64_t{1} << 31);
}

}  // namespace

// Plain C entry points for ctypes; each returns the first CUDA error as an
// int (0 = launched). The wrapper checks devices, dtypes, shapes and
// contiguity, and passes bits = max(1, ceil(log2(n))); the entry points
// refuse rows outside [1, 2^30) (the look-back words count 30 bits), cols
// outside [1, 65535] and n >= 2^31.

// Bytes of scratch a call needs (-1 for arguments the kernel refuses).
extern "C" int64_t sgslam_segment_sum_scratch(int64_t rows, int64_t cols,
                                              int value_bytes, int64_t n,
                                              int bits) {
  if (!args_ok(rows, cols, n, bits)) return -1;
  const size_t pay = value_bytes == 8 && cols == 1 ? 8 : 4;
  return static_cast<int64_t>(carve(nullptr, rows, bits, pay).bytes);
}

extern "C" int sgslam_segment_sum_f32(int device, const void* values,
                                      const void* index, int index_bytes,
                                      const void* init, void* out,
                                      int64_t rows, int64_t cols, int64_t n,
                                      int bits, void* scratch,
                                      int64_t scratch_size, void* stream) {
  if (!args_ok(rows, cols, n, bits))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = set_device(device);
  if (err != 0) return err;
  return launch_index<float, uint32_t>(values, index, index_bytes, init, out,
                                       rows, static_cast<int>(cols), n, bits,
                                       scratch, scratch_size, stream);
}

extern "C" int sgslam_segment_sum_f64(int device, const void* values,
                                      const void* index, int index_bytes,
                                      const void* init, void* out,
                                      int64_t rows, int64_t cols, int64_t n,
                                      int bits, void* scratch,
                                      int64_t scratch_size, void* stream) {
  if (!args_ok(rows, cols, n, bits))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = set_device(device);
  if (err != 0) return err;
  const int c = static_cast<int>(cols);
  if (c == 1)
    return launch_index<double, uint64_t>(values, index, index_bytes, init,
                                          out, rows, c, n, bits, scratch,
                                          scratch_size, stream);
  return launch_index<double, uint32_t>(values, index, index_bytes, init, out,
                                        rows, c, n, bits, scratch,
                                        scratch_size, stream);
}

// The long-segment threshold and block width, for the wrapper's plain
// version.
extern "C" int sgslam_segment_sum_long() { return kLong; }
extern "C" int sgslam_segment_sum_block() { return kBlock; }
