// FAST-9/16 detection for Hopper: the score, the strict 3x3 non-max
// suppression, the border mask and the per-cell best of every level of an
// ORB pyramid in one launch.
//
// It replaces no Pallas kernel. The TPU package computes the same function
// as XLA ops: `sgslam_tpu/ops/fast.py` (`fast_score_map`, `nms_3x3`,
// `border_mask`) and the cell reduction of `sgslam_tpu/ops/orb.py`'s
// `_detect_level`. The port's plain version of them (`ops/fast.py`,
// `ops/orb.py::level_cells`) issues about 236 small kernels a level (16
// ring shifts as gathers, the arcs' mins and maxes, eight more shifts for
// the NMS, the mask, the padded reduction) and copies the threshold to the
// card on every level; this kernel is one launch for the whole pyramid.
//
// What it computes, for every level l and every cell of `cell` x `cell`
// pixels (the level padded with zeros to ceil(h/cell) x ceil(w/cell)
// cells), exactly as the plain version:
//   1. score(y, x) = max over the 16 circular 9-arcs of the ring (the
//      Bresenham circle of radius 3, `fast.CIRCLE`) of the arc's min of
//      ring - centre (bright), and the same of centre - ring (dark); kept
//      where score > threshold, else 0. Reads outside the level take the
//      nearest edge pixel, row and column clamped apart, as the plain
//      version's clamped gathers do; a NaN in any of the 16 differences
//      gives 0, as its NaN-propagating min, max and `>` do;
//   2. the strict 3x3 NMS: a score survives only where it is > 0 and
//      greater than all 8 neighbours, read at clamped positions too;
//   3. the border mask: 0 within `margin` pixels of the level's edges;
//   4. the cell's max and the row-major index inside the cell of its
//      FIRST maximum (`torch.argmax`'s rule; an all-zero cell gives 0).
// Every step is a subtraction, a min, a max or a comparison of float32
// values, so the result is the plain version's to the bit whatever the
// order of evaluation; the arcs are taken as a tree of mins (pairs, fours,
// eights, then the ninth), which is exact. No multiply is involved.
//
// Design. One block of 256 threads per cell, every level's cells in one
// grid (the block finds its level in the prefix sums of cells): the cell
// and a 4-pixel halo (ring radius 3 plus the NMS ring) are loaded into
// shared memory with clamped indices; the score is computed on the cell
// and a 1-pixel ring around it; the NMS, the mask and the padding are
// applied per pixel of the cell, and the block reduces (value, index) to
// the first maximum with warp shuffles in a fixed order. Only the two
// per-cell outputs go to device memory, never an [H, W] map. Level
// pointers and shapes come by value in the kernel's parameters, so a call
// copies nothing to the device.
//
// What bounds it: the levels' bytes, read once (about 4 MB for a 640x480
// pyramid of 8 levels at 1.2), and the outputs written once; the halo
// reads again about (cell + 8)^2 / cell^2 of each cell from L2. PERF.md
// §6 has the measured time beside that bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kMinCell = 8;
constexpr int kMaxCell = 32;
constexpr int kHalo = 4;                       // ring radius 3 + NMS ring
constexpr int kTile = kMaxCell + 2 * kHalo;    // 40
constexpr int kScore = kMaxCell + 2;           // 34
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Levels {
  const float* img[kMaxLevels];     // [h, w] float32, row-major
  int h[kMaxLevels];
  int w[kMaxLevels];
  int ncx[kMaxLevels];              // cells across
  int first[kMaxLevels + 1];        // prefix sums of the levels' cells
  int n_levels;
  int cell;
  int margin;
  float threshold;
  float* cell_score;                // [first[n_levels]] out
  long long* cell_best;             // [first[n_levels]] out
};

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// The FAST score at tile position (ly, lx); see 1. above.
__device__ __forceinline__ float fast_score(const float (*tile)[kTile + 1],
                                            int ly, int lx, float thr) {
  // fast.CIRCLE: (dx, dy), clockwise from 12 o'clock
  constexpr int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                           0, -1, -2, -3, -3, -3, -2, -1};
  constexpr int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                           3, 3, 2, 1, 0, -1, -2, -3};
  const float c = tile[ly][lx];
  float d[16];
  bool nan = false;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    d[k] = tile[ly + kDy[k]][lx + kDx[k]] - c;
    nan |= d[k] != d[k];
  }
  // min and max over the windows d[k .. k+1], d[k .. k+3], d[k .. k+7]
  // (indices mod 16), then with d[k+8]: the 9-arc starting at k
  float mn2[16], mx2[16], mn4[16], mx4[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    mn2[k] = fminf(d[k], d[(k + 1) & 15]);
    mx2[k] = fmaxf(d[k], d[(k + 1) & 15]);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    mn4[k] = fminf(mn2[k], mn2[(k + 2) & 15]);
    mx4[k] = fmaxf(mx2[k], mx2[(k + 2) & 15]);
  }
  float bright = -INFINITY, dark = -INFINITY;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float mn = fminf(fminf(mn4[k], mn4[(k + 4) & 15]), d[(k + 8) & 15]);
    const float mx = fmaxf(fmaxf(mx4[k], mx4[(k + 4) & 15]), d[(k + 8) & 15]);
    bright = fmaxf(bright, mn);
    dark = fmaxf(dark, -mx);        // min over the arc of (centre - ring)
  }
  const float s = fmaxf(bright, dark);
  return (!nan && s > thr) ? s : 0.0f;
}

// (v, i) beats (u, j): a larger value, or the same value at a lower index
__device__ __forceinline__ bool better(float v, int i, float u, int j) {
  return v > u || (v == u && i < j);
}

__global__ void __launch_bounds__(kThreads)
fast_detect_kernel(const __grid_constant__ Levels L) {
  __shared__ float tile[kTile][kTile + 1];
  __shared__ float score[kScore][kScore + 1];
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];

  const int b = blockIdx.x;
  int lv = 0;
  while (lv + 1 < L.n_levels && b >= L.first[lv + 1]) ++lv;
  const int h = L.h[lv], w = L.w[lv], cell = L.cell, m = L.margin;
  const int local = b - L.first[lv];
  const int y0 = (local / L.ncx[lv]) * cell;
  const int x0 = (local % L.ncx[lv]) * cell;
  const float* img = L.img[lv];

  // the cell and its halo, edge-replicated: tile[ty][tx] holds the level
  // at (clamp(y0 - kHalo + ty), clamp(x0 - kHalo + tx))
  const int tn = cell + 2 * kHalo;
  for (int i = threadIdx.x; i < tn * tn; i += kThreads) {
    const int ty = i / tn, tx = i - (i / tn) * tn;
    const int y = clampi(y0 - kHalo + ty, h - 1);
    const int x = clampi(x0 - kHalo + tx, w - 1);
    tile[ty][tx] = __ldg(img + static_cast<size_t>(y) * w + x);
  }
  __syncthreads();

  // the score on the cell and a 1-pixel ring; score[sy][sx] holds the
  // level's score at (clamp(y0 - 1 + sy), clamp(x0 - 1 + sx)), which is
  // what the NMS reads at the edges
  const int sn = cell + 2;
  for (int i = threadIdx.x; i < sn * sn; i += kThreads) {
    const int sy = i / sn, sx = i - (i / sn) * sn;
    const int ly = clampi(y0 - 1 + sy, h - 1) - (y0 - kHalo);
    const int lx = clampi(x0 - 1 + sx, w - 1) - (x0 - kHalo);
    score[sy][sx] = fast_score(tile, ly, lx, L.threshold);
  }
  __syncthreads();

  // NMS, border mask and padding per pixel; each thread keeps its first
  // maximum (its indices rise)
  float best_v = -1.0f;
  int best_i = 0;
  for (int i = threadIdx.x; i < cell * cell; i += kThreads) {
    const int py = i / cell, px = i - (i / cell) * cell;
    const int y = y0 + py, x = x0 + px;
    float v = 0.0f;
    if (y >= m && y < h - m && x >= m && x < w - m) {
      const float s = score[py + 1][px + 1];
      float nmax = score[py][px];
      nmax = fmaxf(nmax, score[py][px + 1]);
      nmax = fmaxf(nmax, score[py][px + 2]);
      nmax = fmaxf(nmax, score[py + 1][px]);
      nmax = fmaxf(nmax, score[py + 1][px + 2]);
      nmax = fmaxf(nmax, score[py + 2][px]);
      nmax = fmaxf(nmax, score[py + 2][px + 1]);
      nmax = fmaxf(nmax, score[py + 2][px + 2]);
      v = (s > nmax && s > 0.0f) ? s : 0.0f;
    }
    if (better(v, i, best_v, best_i)) {
      best_v = v;
      best_i = i;
    }
  }

  // the block's first maximum: within each warp, then across the warps
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_down_sync(0xffffffffu, best_v, off);
    const int i = __shfl_down_sync(0xffffffffu, best_i, off);
    if (better(v, i, best_v, best_i)) {
      best_v = v;
      best_i = i;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red_v[warp] = best_v;
    red_i[warp] = best_i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < kWarps; ++k) {
      if (better(red_v[k], red_i[k], best_v, best_i)) {
        best_v = red_v[k];
        best_i = red_i[k];
      }
    }
    L.cell_score[b] = best_v;
    L.cell_best[b] = static_cast<long long>(best_i);
  }
}

}  // namespace

// The C entry point the Python wrapper binds with ctypes: one launch of
// every level's cells on `stream`, nothing allocated, nothing copied, no
// synchronisation. `imgs`, `hs`, `ws` are host arrays of `n_levels`
// entries. Returns cudaGetLastError() as an int (0 = launched), or
// cudaErrorInvalidValue for arguments outside the kernel's limits.
extern "C" int sgslam_fast_detect(const void* const* imgs, const int* hs,
                                  const int* ws, int n_levels, int cell,
                                  int margin, float threshold,
                                  void* cell_score, void* cell_best,
                                  void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || cell < kMinCell ||
      cell > kMaxCell || margin < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels L;
  L.first[0] = 0;
  for (int l = 0; l < n_levels; ++l) {
    if (hs[l] < 1 || ws[l] < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    L.img[l] = static_cast<const float*>(imgs[l]);
    L.h[l] = hs[l];
    L.w[l] = ws[l];
    L.ncx[l] = (ws[l] + cell - 1) / cell;
    const long long cells =
        static_cast<long long>((hs[l] + cell - 1) / cell) * L.ncx[l];
    if (L.first[l] + cells > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    L.first[l + 1] = L.first[l] + static_cast<int>(cells);
  }
  for (int l = n_levels; l < kMaxLevels; ++l) {
    L.img[l] = nullptr;
    L.h[l] = L.w[l] = L.ncx[l] = 0;
    L.first[l + 1] = L.first[n_levels];
  }
  L.n_levels = n_levels;
  L.cell = cell;
  L.margin = margin;
  L.threshold = threshold;
  L.cell_score = static_cast<float*>(cell_score);
  L.cell_best = static_cast<long long*>(cell_best);
  fast_detect_kernel<<<L.first[n_levels], kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(L);
  return static_cast<int>(cudaGetLastError());
}
