// Fused Hamming search (K1s) for Hopper: distance, candidate mask and best
// two per query row in one kernel, so that no [q, n] matrix is written.
//
// Every association search of the port (matching/search.py) wants, per
// query row i, over
//
//     dm[i, j] = cand[i, j] ? sum_{w < 8} popc(q[i, w] ^ t[j, w]) : 256
//
// the first argmin (best_idx, int64, as torch.argmin gives it), the minimum
// (best) and `_second_min`'s value (second: the row's minimum once the entry
// at best_idx is set to 256); the mutual check also wants each column's
// first argmin over the rows (rbest). The TPU computes dm with its Pallas
// kernel `_hamming_kernel` (sgslam_tpu/ops/pallas_hamming.py:34), or with
// the bit-plane matmul `hamming_matrix_mxu` on its production route, and
// reduces it in XLA. This kernel does the whole search; K1
// (csrc/hamming.cu) stays the counterpart of `_hamming_kernel`, off the
// path. The candidate mask is
//   * with a window (search_by_projection): |feat_x - u| <= r and
//     |feat_y - v| <= r in float32 (u, v = proj_uv[i], r = r[i], computed
//     by torch), |feat_level - pred_level| <= level_window in int32, and
//     valid_t[j] and valid_q[i];
//   * without (match_by_descriptor): valid_q[i] and valid_t[j].
// Built without --use_fast_math: flushing denormals to zero would change
// `|du| <= r` near zero.
//
// The first-index rule across the masked fill. Every entry of dm is <= 256,
// so a row's argmin is the lowest column among its minima, and a row whose
// candidates all lie at 256 (or that has none) takes column 0, whether or
// not column 0 is a candidate. The kernel keeps, per row, the minimum key
// (dm << 16 | j) and the second-smallest key of the row, starting both at
// (256 << 16 | 0): that virtual entry stands for every non-candidate entry,
// each of which is (256, j) with j >= 0. Non-candidates then need not be
// told apart from candidates that lose: a non-candidate's distance is set
// to 512 or more (512 is added for an invalid row or column), which no
// update can take below the virtual entry. best = key >> 16, best_idx =
// key & 0xffff (so n < 65536), second = second key >> 16. The same holds
// per column with the key (dm << 32 | i): only candidates with dm < 256
// can beat (256, row 0).
//
// What bounds it on an H100 SXM at the tracking search's 4096 x 1024:
//   * bytes: the inputs are (4096 + 1024) x 32 bytes of descriptors plus
//     4096 x 17 and 1024 x 13 bytes of windows, levels and flags; the
//     outputs 4096 x 16 bytes: about 0.31 MB, 0.09 us at 3.35 TB/s.
//   * operations: every pair's distance by the route the card runs
//     fastest, |a| + |b| - 2 <bits_a, bits_b> on the tensor cores, is
//     2 x 4096 x 1024 x 256 int8 operations at 1,979 TOP/s, 1.09 us. A
//     windowed search needs every pair's window test (7 float and
//     integer operations, 0.44 us at 67 TFLOP/s) but only its
//     candidates' distances: a few per row.
//   Beyond that every computed pair costs some 10 integer operations for
//   the key, the mask and the two running minima, which no bound counts.
//
// Design. A block of 4 warps owns 16 query rows and a share of the column
// tiles (128 columns each): the grid is (splits, row tiles), with splits
// chosen by the wrapper so that 1024 x 1024 and 4096 x 1024 both give at
// least two blocks per SM. The block stages its rows once, then streams its
// column tiles (descriptors, positions, levels, flags) through shared
// memory with cp.async, double-buffered, the last tile zero-filled past n.
// Descriptor halves are stored swizzled (half h of column c at slot
// h ^ ((c >> 2) & 1)) so that the fragments below read them without bank
// conflicts. The inner product is the tensor cores': warp w owns the
// tile's columns 32w..32w+31 as four n8 tiles, and one
// `mma.sync.m16n8k256.b1.and.popc` gives popc(a & b) of 16 x 8 pairs, so
// that d = |a| + |b| - 2 popc(a & b) exactly in int32 (|a|, |b| computed
// at staging). With a window, a warp tests the window of its pairs first
// and issues the product only where one of its lanes has a candidate (a
// warp vote; the candidates are a few per row). Each thread keeps its two
// rows' running (best key, second key) in registers, less the row's part
// of the key, so that a pair costs no add for it; at the end warp
// shuffles merge the lanes, and shared memory the warps.
// Measured on an H100 SXM (700 W) by CUDA-graph replay at 4096 x 1024
// with a window: 8.3-8.6 us, against 9.9-10.1 us for 8 XOR + popc per pair
// on the CUDA cores, the other inner product tried (PERF.md); the torch
// chain it replaces 173 us. About 4.5 us of it is the cost of any launch
// at these sizes (K1 takes 4.5 us at 640 x 640).
// With more than one split, each block writes its rows' (best, second) keys
// to a [splits, q] buffer and counts itself done on its row tile; the last
// block of the tile merges the splits (the merge of (best, second) pairs is
// order-free, so the result repeats) and writes the outputs. With `mutual`
// each tile's column keys are reduced over the block's rows in shared
// memory (atomicMin), then one 64-bit atomicMax per column and block of
// ((256 - dm) << 32 | ~row) into an [n] buffer, which the last block of
// the grid decodes into rbest (0 where no candidate beat the fill); a
// maximum does not depend on the order of the atomics either. The column
// buffer and the counters live in a workspace that the wrapper zeroes once
// and the kernel leaves zeroed (the last blocks reset what they read), so
// that a search is one launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;
constexpr int kThreads = 128;                // 4 warps
constexpr int kRows = 16;                    // query rows per block
constexpr int kCols = 128;                   // columns per tile
constexpr int kFill = 256;                   // MAX_DIST, the masked fill
constexpr int kOff = 512;                    // distance of an invalid pair
constexpr uint32_t kEmpty = uint32_t(kFill) << 16;   // (fill, column 0)
constexpr uint32_t kOffKey = uint32_t(kOff) << 16;   // a non-candidate

struct Args {
  const int4* desc_q;           // [q, 8] int32, as [q, 2] int4
  const uint8_t* valid_q;       // [q] bool
  const int4* desc_t;           // [n, 8] int32
  const uint8_t* valid_t;       // [n] bool
  const float2* proj_uv;        // [q, 2] float32 (window only)
  const float* r;               // [q] float32
  const int* pred_level;        // [q] int32
  const float2* feat_xy;        // [n, 2] float32
  const int* feat_level;        // [n] int32
  int level_window;
  int q, n, n_tiles, splits;
  long long* best_idx;          // [q] int64
  int* best;                    // [q] int32
  int* second;                  // [q] int32
  long long* rbest;             // [n] int64 (mutual only)
  unsigned long long* partials; // [splits, q] (splits > 1 only)
  unsigned long long* colbuf;   // [n], zero at entry and exit (mutual)
  unsigned* counters;           // [row tiles + 1], zero at entry and exit
};

struct __align__(16) Tile {
  int4 desc[kCols][2];          // swizzled halves
  float2 xy[kCols];
  int level[kCols];
  int key[kCols];               // (512 if invalid; + |t_j|) << 16 | column
  uint8_t valid[kCols];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ int clamp16(int bytes) {
  return bytes < 0 ? 0 : (bytes > 16 ? 16 : bytes);
}

// The running (best, second) keys of a row take one more key.
template <typename T>
__device__ __forceinline__ void take(T& b, T& s, T k) {
  s = min(s, max(b, k));
  b = min(b, k);
}

// Merge another (best, second) pair of the same row.
template <typename T>
__device__ __forceinline__ void merge(T& b, T& s, T b2, T s2) {
  s = min(min(s, s2), max(b, b2));
  b = min(b, b2);
}

template <typename T>
__device__ __forceinline__ void merge_lanes(T& b, T& s, int lane_mask) {
  const T b2 = __shfl_xor_sync(0xffffffffu, b, lane_mask);
  const T s2 = __shfl_xor_sync(0xffffffffu, s, lane_mask);
  merge(b, s, b2, s2);
}

// Does any lane of the warp hold a candidate? (warp-uniform)
__device__ __forceinline__ bool warp_any(bool c) {
  return __any_sync(0xffffffffu, c);
}

// |feat_level - pred_level| <= level_window as torch computes it in int32:
// the difference wraps, and abs(INT_MIN) stays negative.
__device__ __forceinline__ bool level_ok(int fl, int pl, int lw) {
  const uint32_t dl = uint32_t(fl) - uint32_t(pl);
  const int a = int(dl) < 0 ? int(0u - dl) : int(dl);
  return a <= lw;
}

__device__ __forceinline__ int popc8(int4 lo, int4 hi) {
  return __popc(lo.x) + __popc(lo.y) + __popc(lo.z) + __popc(lo.w) +
         __popc(hi.x) + __popc(hi.y) + __popc(hi.z) + __popc(hi.w);
}

template <bool WINDOW>
__device__ void issue_tile(Tile& t, const Args& p, int col0) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int id = tid + k * kThreads;
    const int c = id >> 1, h = id & 1;
    const int gc = col0 + c;
    const bool in = gc < p.n;
    cp_async16(&t.desc[c][h ^ ((c >> 2) & 1)],
               in ? p.desc_t + 2 * gc + h : p.desc_t, in ? 16 : 0);
  }
  if (WINDOW && tid < kCols / 2) {                  // 2 columns a chunk
    const int c = col0 + 2 * tid;
    const int bytes = clamp16((p.n - c) * 8);
    cp_async16(&t.xy[2 * tid], bytes ? p.feat_xy + c : p.feat_xy, bytes);
  } else if (WINDOW && tid < kCols / 2 + kCols / 4) {   // 4 a chunk
    const int i = tid - kCols / 2;
    const int c = col0 + 4 * i;
    const int bytes = clamp16((p.n - c) * 4);
    cp_async16(&t.level[4 * i], bytes ? p.feat_level + c : p.feat_level,
               bytes);
  } else if (tid >= kCols - kCols / 16) {           // 16 flags a chunk
    const int i = tid - (kCols - kCols / 16);
    const int c = col0 + 16 * i;
    const int bytes = clamp16(p.n - c);
    cp_async16(&t.valid[16 * i], bytes ? p.valid_t + c : p.valid_t, bytes);
  }
}

template <bool WINDOW, bool MUTUAL>
__global__ void __launch_bounds__(kThreads)
search_kernel(const Args p) {
  __shared__ Tile tiles[2];
  __shared__ int4 s_rdesc[kRows][2];
  __shared__ float4 s_rwin[kRows];           // u, v, r, pred_level (bits)
  __shared__ int s_rbias[kRows];             // 512 if invalid; + |q_i|
  __shared__ uint32_t s_colkey[kCols];       // (dm << 16 | local row)
  __shared__ uint32_t s_part[4][kRows][2];   // per warp
  __shared__ uint32_t s_best[kRows], s_sec[kRows];
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.y * kRows;

  // ---- the block's rows ----------------------------------------------------
  if (tid < kRows) {
    const int row = row0 + tid;
    const bool in = row < p.q;
    int4 lo = make_int4(0, 0, 0, 0), hi = lo;
    bool valid = false;
    float4 win = make_float4(0.f, 0.f, 0.f, 0.f);
    if (in) {
      lo = p.desc_q[2 * row];
      hi = p.desc_q[2 * row + 1];
      valid = p.valid_q[row] != 0;
      if (WINDOW) {
        const float2 uv = p.proj_uv[row];
        win = make_float4(uv.x, uv.y, p.r[row],
                          __int_as_float(p.pred_level[row]));
      }
    }
    s_rdesc[tid][0] = lo;
    s_rdesc[tid][1] = hi;
    s_rwin[tid] = win;
    s_rbias[tid] = (valid ? 0 : kOff) + popc8(lo, hi);
  }
  if (MUTUAL) s_colkey[tid] = 0xffffffffu;

  int tile = blockIdx.x;
  issue_tile<WINDOW>(tiles[0], p, tile * kCols);
  cp_async_commit();
  __syncthreads();

  // ---- per-thread row state ------------------------------------------------
  // A row's running keys are kept less its row part rkey (its distance
  // bias << 16), which is the same for every column: key - rkey as a
  // signed int, so that a pair costs no add for it.
  constexpr int kMine = 2;                   // rows per thread
  int best[kMine], sec[kMine], rkey[kMine], off[kMine];
  int rlevel[kMine];
  const int lw = p.level_window;
  float ru[kMine], rv[kMine], rr[kMine];
  const int g = lane >> 2, t4 = lane & 3;    // mma group, thread in group
#pragma unroll
  for (int i = 0; i < kMine; ++i) {
    const int r = g + 8 * i;
    rkey[i] = s_rbias[r] << 16;
    best[i] = int(kEmpty) - rkey[i];
    sec[i] = best[i];
    off[i] = int(kOffKey) - rkey[i];         // a non-candidate's key
    const float4 w = s_rwin[r];
    ru[i] = w.x;
    rv[i] = w.y;
    rr[i] = w.z;
    rlevel[i] = __float_as_int(w.w);
  }
  // the rows' bits as the mma's A fragment: row g, bits 32 t .. 32 t + 31;
  // row g + 8; row g, bits 128 + 32 t ..; row g + 8
  const uint32_t* lo_g = reinterpret_cast<const uint32_t*>(s_rdesc[g]);
  const uint32_t* lo_g8 = reinterpret_cast<const uint32_t*>(s_rdesc[g + 8]);
  const uint32_t afrag[4] = {lo_g[t4], lo_g8[t4], lo_g[t4 + 4],
                             lo_g8[t4 + 4]};

  // ---- stream the column tiles -------------------------------------------
  for (int k = 0; tile < p.n_tiles; ++k, tile += p.splits) {
    Tile& cur = tiles[k & 1];
    const int col0 = tile * kCols;
    const int next = tile + p.splits;
    if (next < p.n_tiles) {
      issue_tile<WINDOW>(tiles[(k + 1) & 1], p, next * kCols);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    {   // each thread one column: its part of the keys
      const int sw = (tid >> 2) & 1;
      int b = cur.valid[tid] ? 0 : kOff;
      b += popc8(cur.desc[tid][sw], cur.desc[tid][sw ^ 1]);
      cur.key[tid] = (b << 16) + col0 + tid;
    }
    __syncthreads();

    // warp w: columns 32 w .. 32 w + 31 as four n8 tiles; per tile the
    // window test first, the product only where a lane needs it
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n0 = warp * 32 + nt * 8;
      const int j0 = n0 + 2 * t4;       // acc: (g, j0), (g, j0 + 1),
      bool cand[4] = {true, true, true, true};   // (g + 8, j0), ...
      if (WINDOW) {
        const float4 xy = *reinterpret_cast<const float4*>(&cur.xy[j0]);
        bool any = false;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, j = e & 1;
          cand[e] = (fabsf((j ? xy.z : xy.x) - ru[i]) <= rr[i]) &
                    (fabsf((j ? xy.w : xy.y) - rv[i]) <= rr[i]);
          any |= cand[e];
        }
        if (!warp_any(any)) continue;
        const int2 cl = *reinterpret_cast<const int2*>(&cur.level[j0]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cand[e] &= level_ok((e & 1) ? cl.y : cl.x, rlevel[e >> 1], lw);
      }
      const int cB = n0 + g;
      const int sw = (cB >> 2) & 1;
      const uint32_t* dw = reinterpret_cast<const uint32_t*>(cur.desc[cB]);
      const uint32_t b0 = dw[4 * sw + t4];          // bits 32 t ..
      const uint32_t b1 = dw[4 * (sw ^ 1) + t4];    // bits 128 + 32 t ..
      int acc[4];
      asm volatile(
          "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%10, %10, %10, %10};\n"
          : "=r"(acc[0]), "=r"(acc[1]), "=r"(acc[2]), "=r"(acc[3])
          : "r"(afrag[0]), "r"(afrag[1]), "r"(afrag[2]), "r"(afrag[3]),
            "r"(b0), "r"(b1), "r"(0));
      const int2 cb = *reinterpret_cast<const int2*>(&cur.key[j0]);
      uint32_t ck[2] = {0xffffffffu, 0xffffffffu};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, j = e & 1;
        // (|b| - 2 popc(a & b)) << 16 | column; |a| is in rkey
        int key = (j ? cb.y : cb.x) - (acc[e] << 17);
        if (WINDOW) key = cand[e] ? key : off[i];
        take(best[i], sec[i], key);
        if (MUTUAL)
          ck[j] = min(ck[j], (uint32_t(key + rkey[i]) & 0xffff0000u) |
                                 uint32_t(g + 8 * i));
      }
      if (MUTUAL) {
        atomicMin(&s_colkey[j0], ck[0]);
        atomicMin(&s_colkey[j0 + 1], ck[1]);
      }
    }
    __syncthreads();
    if (MUTUAL) {   // each thread one column: the block's rows' best
      const uint32_t key = s_colkey[tid];
      s_colkey[tid] = 0xffffffffu;
      const int gc = col0 + tid;
      const uint32_t dm = key >> 16;
      if (gc < p.n && dm < uint32_t(kFill)) {
        const uint32_t row = uint32_t(row0) + (key & 0xffffu);
        atomicMax(&p.colbuf[gc],
                  (static_cast<unsigned long long>(kFill - dm) << 32) | ~row);
      }
    }
  }

  // ---- merge the rows' lanes and warps (keys with their row part) -------
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    merge_lanes(best[i], sec[i], 1);
    merge_lanes(best[i], sec[i], 2);
    if (t4 == 0) {
      s_part[warp][g + 8 * i][0] = uint32_t(best[i] + rkey[i]);
      s_part[warp][g + 8 * i][1] = uint32_t(sec[i] + rkey[i]);
    }
  }
  __syncthreads();
  if (tid < kRows) {
    uint32_t b = s_part[0][tid][0], s = s_part[0][tid][1];
#pragma unroll
    for (int w = 1; w < 4; ++w)
      merge(b, s, s_part[w][tid][0], s_part[w][tid][1]);
    s_best[tid] = b;
    s_sec[tid] = s;
  }
  __syncthreads();

  // ---- outputs -------------------------------------------------------------
  const int row = row0 + tid;
  const bool mine = tid < kRows && row < p.q;
  if (p.splits == 1) {
    if (mine) {
      p.best_idx[row] = static_cast<long long>(s_best[tid] & 0xffffu);
      p.best[row] = static_cast<int>(s_best[tid] >> 16);
      p.second[row] = static_cast<int>(s_sec[tid] >> 16);
    }
  } else {
    if (mine) {
      p.partials[static_cast<size_t>(blockIdx.x) * p.q + row] =
          (static_cast<unsigned long long>(s_best[tid]) << 32) | s_sec[tid];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(&p.counters[blockIdx.y], 1u) ==
                           unsigned(p.splits - 1);
    __syncthreads();
    if (s_last) {
      __threadfence();
      if (mine) {
        uint32_t b = kEmpty, s = kEmpty;
        for (int sp = 0; sp < p.splits; ++sp) {
          const unsigned long long v =
              __ldcg(&p.partials[static_cast<size_t>(sp) * p.q + row]);
          merge(b, s, uint32_t(v >> 32), uint32_t(v));
        }
        p.best_idx[row] = static_cast<long long>(b & 0xffffu);
        p.best[row] = static_cast<int>(b >> 16);
        p.second[row] = static_cast<int>(s >> 16);
      }
      if (tid == 0) p.counters[blockIdx.y] = 0;   // zero for the next call
    }
  }
  if (MUTUAL) {
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(&p.counters[gridDim.y], 1u) ==
                           gridDim.x * gridDim.y - 1;
    __syncthreads();
    if (s_last) {
      __threadfence();
      for (int j = tid; j < p.n; j += kThreads) {
        const unsigned long long v = atomicExch(&p.colbuf[j], 0ull);
        p.rbest[j] = (v >> 32) ? static_cast<long long>(~uint32_t(v)) : 0;
      }
      if (tid == 0) p.counters[gridDim.y] = 0;
    }
  }
}

template <bool WINDOW, bool MUTUAL>
cudaError_t launch(const Args& p, dim3 grid, cudaStream_t s) {
  search_kernel<WINDOW, MUTUAL><<<grid, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream` and returns
// cudaGetLastError() as an int (0 = launched). The window pointers are
// null for match_by_descriptor; `colbuf` and `counters` point into one
// zeroed workspace ([n] u64, then row tiles + 1 u32), which the kernel
// leaves zeroed, when `mutual` or splits > 1; `partials` to [splits, q]
// u64 when splits > 1. Calls that share a workspace must run in order
// (one stream). The Python
// wrapper checks types, shapes, 16-byte alignment and 0 < n < 65536.
extern "C" int sgslam_hamming_search(
    const void* desc_q, const void* valid_q, const void* desc_t,
    const void* valid_t, const void* proj_uv, const void* r,
    const void* pred_level, const void* feat_xy, const void* feat_level,
    int level_window, int q, int n, int splits, int mutual,
    void* best_idx, void* best, void* second, void* rbest, void* partials,
    void* colbuf, void* counters, void* stream) {
  Args p;
  p.desc_q = static_cast<const int4*>(desc_q);
  p.valid_q = static_cast<const uint8_t*>(valid_q);
  p.desc_t = static_cast<const int4*>(desc_t);
  p.valid_t = static_cast<const uint8_t*>(valid_t);
  p.proj_uv = static_cast<const float2*>(proj_uv);
  p.r = static_cast<const float*>(r);
  p.pred_level = static_cast<const int*>(pred_level);
  p.feat_xy = static_cast<const float2*>(feat_xy);
  p.feat_level = static_cast<const int*>(feat_level);
  p.level_window = level_window;
  p.q = q;
  p.n = n;
  p.n_tiles = (n + kCols - 1) / kCols;
  p.splits = splits;
  p.best_idx = static_cast<long long*>(best_idx);
  p.best = static_cast<int*>(best);
  p.second = static_cast<int*>(second);
  p.rbest = static_cast<long long*>(rbest);
  p.partials = static_cast<unsigned long long*>(partials);
  p.colbuf = static_cast<unsigned long long*>(colbuf);
  p.counters = static_cast<unsigned*>(counters);
  const dim3 grid(splits, (q + kRows - 1) / kRows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool window = proj_uv != nullptr;
  cudaError_t err;
  if (window)
    err = mutual ? launch<true, true>(p, grid, s)
                 : launch<true, false>(p, grid, s);
  else
    err = mutual ? launch<false, true>(p, grid, s)
                 : launch<false, false>(p, grid, s);
  return static_cast<int>(err);
}

// Rows per block and columns per tile, for the wrapper's grid.
extern "C" int sgslam_hamming_search_rows() { return kRows; }
extern "C" int sgslam_hamming_search_cols() { return kCols; }
