// Motion-only bundle adjustment for Hopper: every round and iteration of
// `optim/pose_opt.py::pose_optimization` in one launch.
//
// The plain body (Gauss-Newton on one camera pose against fixed 3-D points,
// ORB-SLAM2's Optimizer::PoseOptimization contract) issues about 200 small
// kernels an iteration for 27 numbers of work: per point the residual r
// [3] and the Jacobian J [3, 6] wrt a left-multiplied twist, then
// H = sum_n w_n J_n^T J_n and b = sum_n w_n J_n^T r_n, one 6x6 solve and an
// SE(3) update. The TPU package runs it as XLA ops; there is no Pallas
// kernel to translate. Here one thread block runs the whole call:
//
//   for each round (Huber weights in rounds 0 and 1, none after):
//     for each iteration:
//       every thread forms r, J, chi2 and the weight of its points and sums
//         the 21 upper entries of H, the 6 of b and the robust cost;
//       the block adds the threads' sums in a fixed tree;
//       one thread solves (H + 1e-5 I) dx = -b (LU, partial pivoting) and
//         composes exp(dx) with the pose;
//       guarded: the cost at the new pose, kept only if it fell;
//     inlier = valid & chi2(pose) <= delta2 (7.815 stereo, 5.991 mono);
//   then the pose, the inlier mask and their count are written.
//
// Rounding. The per-point arithmetic is the plain body's, op for op in
// float32: this file is built with -fmad=false, so every product and sum
// rounds on its own as each torch op does, and fmaf() stands where the
// plain body's contraction runs in a GEMM (J = Jproj @ dpc, J^T J and
// J^T r over the three rows, hat(w) @ v), accumulating over the inner
// index in order. Each thread sums its points' terms in float32 (8 at
// N = 4096) and the block adds the 512 partial sums in float64; the
// robust cost is summed in float64 throughout. The 6x6 system is rounded
// to float32 and solved in float32 as torch.linalg.solve does. The sums
// use no atomics and a fixed order, so a call repeats to the bit.
//
// What bounds it: latency, not the card's throughput. At N = 4096 an
// iteration is ~4096 x 200 float32 operations (a few microseconds of one
// SM's issue), two block barriers, and a serial 6x6 solve and SE(3)
// exponential on one thread; PERF.md §6 has the measured times. The
// iterations depend on each other, so one SM is all a call can use; what
// it saves is the host's ~200 launches an iteration. The points (28 bytes
// each) are read from global memory every pass and stay in L1 (112 KB at
// N = 4096).
//
// Design notes. One block of 512 threads: the float32 sums of a thread
// (27), its robust cost (float64) and the 32-slot float64 reduction fit
// 128 registers; 1024 threads would leave 64. Point i belongs to thread
// i % 512 for the whole call, so the inlier flags live in the output
// array, written and read by their owner thread only. The 28 sums leave a
// warp by a transposing butterfly (31 float64 shuffles: lane l ends with
// the warp's sum of slot l), then warp 0 adds the 16 warps' slots in
// warp order. Loops have constant bounds, so that they unroll and the
// small arrays stay in registers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUpper = 21;            // upper triangle of H, row-major
constexpr int kSums = kUpper + 6 + 1; // H, b, robust cost
constexpr float kEps = 1e-8f;         // geometry/se3.py's _EPS
constexpr float kDamping = 1e-5f;     // pose_opt.py's eye6

struct Args {
  const float* tcw0;        // [7] (qw, qx, qy, qz, tx, ty, tz)
  const float* pw;          // [n, 3]
  const float* obs;         // [n, 3] (u, v, u_right; u_right < 0: mono)
  const float* inv_sigma2;  // [n]
  const uint8_t* valid;     // [n]
  float* tcw;               // [7] out
  uint8_t* inlier;          // [n] out (and the inlier state during the call)
  long long* n_inliers;     // [] out
  int n;
  float fx, fy, cx, cy, bf;
  int rounds, iters, guarded;
  float chi2_mono, chi2_stereo;
};

struct Pose {
  float q[4];
  float t[3];
};

struct Point {
  float pw[3];
  float o[3];
  float is2;
  float delta2;
  bool stereo;
};

// torch.clamp(x, min=lo): a NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ void cross(const float a[3], const float b[3],
                                      float o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// se3.quat_rotate: t = 2 u x v; v + w t + u x t.
__device__ __forceinline__ void quat_rotate(const float q[4], const float v[3],
                                            float o[3]) {
  const float u[3] = {q[1], q[2], q[3]};
  float t[3], c[3];
  cross(u, v, t);
  t[0] = 2.0f * t[0];
  t[1] = 2.0f * t[1];
  t[2] = 2.0f * t[2];
  cross(u, t, c);
  for (int i = 0; i < 3; ++i) o[i] = (v[i] + q[0] * t[i]) + c[i];
}

// se3.quat_normalize.
__device__ __forceinline__ void quat_normalize(float q[4]) {
  const float n = sqrtf(((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) +
                        q[3] * q[3]);
  const float d = clamp_min(n, kEps);
  for (int i = 0; i < 4; ++i) q[i] = q[i] / d;
}

// (hat(w) @ v)[i] as a GEMM forms it: k = 0, 1, 2 with fused adds.
__device__ __forceinline__ void hat_mul(const float w[3], const float v[3],
                                        float o[3]) {
  const float W[3][3] = {{0.0f, -w[2], w[1]},
                         {w[2], 0.0f, -w[0]},
                         {-w[1], w[0], 0.0f}};
  for (int i = 0; i < 3; ++i)
    o[i] = fmaf(W[i][2], v[2], fmaf(W[i][1], v[1], W[i][0] * v[0]));
}

// se3.se3_exp (with _rot_coeffs' and so3_exp_quat's small-angle branches).
__device__ __forceinline__ void se3_exp(const float xi[6], Pose& out) {
  const float v[3] = {xi[0], xi[1], xi[2]};
  const float w[3] = {xi[3], xi[4], xi[5]};
  const float theta2 = (w[0] * w[0] + w[1] * w[1]) + w[2] * w[2];
  const float theta = sqrtf(clamp_min(theta2, 0.0f));
  const bool small = theta < 1e-2f;
  const float b = small ? 0.5f - theta2 / 24.0f
                        : (1.0f - cosf(theta)) / clamp_min(theta2, kEps);
  const float c = small ? static_cast<float>(1.0 / 6.0) - theta2 / 120.0f
                        : (theta - sinf(theta)) /
                              clamp_min(theta2 * theta, kEps);
  float wxv[3], wxwxv[3];
  hat_mul(w, v, wxv);
  hat_mul(w, wxv, wxwxv);
  for (int i = 0; i < 3; ++i) out.t[i] = (v[i] + b * wxv[i]) + c * wxwxv[i];

  const float half = 0.5f * theta;
  const bool tiny = theta < 1e-4f;
  const float k = tiny ? 0.5f - theta2 / 48.0f
                       : sinf(half) / clamp_min(theta, kEps);
  out.q[0] = tiny ? 1.0f - theta2 / 8.0f : cosf(half);
  out.q[1] = k * w[0];
  out.q[2] = k * w[1];
  out.q[3] = k * w[2];
  quat_normalize(out.q);
}

// se3.se3_compose(a, b): (a * b) x = a(b(x)).
__device__ __forceinline__ void se3_compose(const Pose& a, const Pose& b,
                                            Pose& out) {
  const float *p = a.q, *r = b.q;
  out.q[0] = p[0] * r[0] - p[1] * r[1] - p[2] * r[2] - p[3] * r[3];
  out.q[1] = p[0] * r[1] + p[1] * r[0] + p[2] * r[3] - p[3] * r[2];
  out.q[2] = p[0] * r[2] - p[1] * r[3] + p[2] * r[0] + p[3] * r[1];
  out.q[3] = p[0] * r[3] + p[1] * r[2] - p[2] * r[1] + p[3] * r[0];
  float t[3];
  quat_rotate(a.q, b.t, t);
  for (int i = 0; i < 3; ++i) out.t[i] = t[i] + a.t[i];
  quat_normalize(out.q);
}

__device__ __forceinline__ Point load_point(const Args& a, int i) {
  Point p;
  for (int k = 0; k < 3; ++k) {
    p.pw[k] = __ldg(a.pw + 3 * i + k);
    p.o[k] = __ldg(a.obs + 3 * i + k);
  }
  p.is2 = __ldg(a.inv_sigma2 + i);
  p.stereo = p.o[2] >= 0.0f;
  p.delta2 = p.stereo ? a.chi2_stereo : a.chi2_mono;
  return p;
}

// pose_opt._residual_jac's residual at T: r [3] and pc, z, 1/z; returns
// chi2 = sum(r * r) * inv_sigma2.
__device__ __forceinline__ float residual(const Args& a, const Pose& T,
                                          const Point& p, float pc[3],
                                          float r[3], float& invz) {
  quat_rotate(T.q, p.pw, pc);
  for (int k = 0; k < 3; ++k) pc[k] = pc[k] + T.t[k];
  const float z = clamp_min(pc[2], 1e-6f);
  invz = 1.0f / z;
  const float u = a.fx * pc[0] * invz + a.cx;
  const float v = a.fy * pc[1] * invz + a.cy;
  const float ur = u - a.bf * invz;
  r[0] = u - p.o[0];
  r[1] = v - p.o[1];
  r[2] = p.stereo ? ur - p.o[2] : 0.0f;
  return (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * p.is2;
}

// pose_opt._huber_weight.
__device__ __forceinline__ float huber(float chi2, float delta2) {
  return chi2 <= delta2 ? 1.0f : sqrtf(delta2 / clamp_min(chi2, 1e-12f));
}

struct Sums {
  float h[kUpper];
  float g[6];
  double cost;
};

// One point's terms of H, b and the robust cost at T, added to s.
__device__ __forceinline__ void accumulate(const Args& a, const Pose& T,
                                           const Point& p, bool inl,
                                           bool use_huber, Sums& s) {
  float pc[3], r[3], invz;
  const float chi2 = residual(a, T, p, pc, r, invz);
  const float x = pc[0], y = pc[1], zr = pc[2];
  // Jproj rows: du, dv and (stereo) dur = du + (0, 0, bf / z^2).
  const float du0 = a.fx * invz;
  const float du2 = -a.fx * x * invz * invz;
  const float dv1 = a.fy * invz;
  const float dv2 = -a.fy * y * invz * invz;
  const float dur2 = du2 + a.bf * invz * invz;
  const float jp[3][3] = {{du0, 0.0f, du2},
                          {0.0f, dv1, dv2},
                          {p.stereo ? du0 : 0.0f, 0.0f,
                           p.stereo ? dur2 : 0.0f}};
  // J = Jproj @ [I | -hat(pc)]: columns 0-2 are Jproj's, 3-5 the products
  // with (0, -z, y), (z, 0, -x), (-y, x, 0), k = 0, 1, 2 in order.
  float J[3][6];
#pragma unroll
  for (int row = 0; row < 3; ++row) {
    const float* j = jp[row];
    J[row][0] = j[0];
    J[row][1] = j[1];
    J[row][2] = j[2];
    J[row][3] = fmaf(j[2], y, fmaf(j[1], -zr, j[0] * 0.0f));
    J[row][4] = fmaf(j[2], -x, fmaf(j[1], 0.0f, j[0] * zr));
    J[row][5] = fmaf(j[2], 0.0f, fmaf(j[1], x, j[0] * -y));
  }
  const float hw = use_huber ? huber(chi2, p.delta2) : 1.0f;
  const float inl_f = inl ? 1.0f : 0.0f;
  const float wn = p.is2 * hw * inl_f;
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      if (j < i) continue;
      const float jtj = fmaf(J[2][i], J[2][j],
                             fmaf(J[1][i], J[1][j], J[0][i] * J[0][j]));
      s.h[k] = fmaf(wn, jtj, s.h[k]);
      ++k;
    }
    const float jtr = fmaf(J[2][i], r[2], fmaf(J[1][i], r[1], J[0][i] * r[0]));
    s.g[i] = fmaf(wn, jtr, s.g[i]);
  }
  s.cost += static_cast<double>(chi2 * hw * inl_f);
}

// One level of the transposing butterfly: lanes that differ in bit S
// swap halves of their 2S live slots and add, keeping the half that bit S
// selects in v[0, S).
template <int S>
__device__ __forceinline__ void transpose_level(double (&v)[32], int lane) {
  const bool upper = lane & S;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const double send = upper ? v[j] : v[j + S];
    const double keep = upper ? v[j + S] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, S);
  }
}

// Lane l of the warp returns the warp's sum of v[l] (slots >= kSums are 0).
__device__ __forceinline__ double warp_transpose_sum(double (&v)[32],
                                                     int lane) {
  transpose_level<16>(v, lane);
  transpose_level<8>(v, lane);
  transpose_level<4>(v, lane);
  transpose_level<2>(v, lane);
  transpose_level<1>(v, lane);
  return v[0];
}

// The block's sum of x, in thread 0 (fixed order).
__device__ __forceinline__ double block_sum(double x, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) total += red[w];
  __syncthreads();  // red is reused by the next call
  return total;
}

// Solve (H + damping I) dx = -b in float32 by LU with partial pivoting
// (the first largest |pivot|, LAPACK's getrf/getrs order); a zero pivot
// runs on into inf and NaN, as torch.linalg.solve_ex does. Every loop has
// constant bounds, so that A and rhs stay in registers once unrolled.
__device__ __forceinline__ void solve6(const double* tot, float dx[6]) {
  float A[6][6], rhs[6];
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      if (j < i) continue;
      const float h = static_cast<float>(tot[k++]);
      A[i][j] = i == j ? h + kDamping : h;
      A[j][i] = A[i][j];
    }
#pragma unroll
  for (int i = 0; i < 6; ++i) rhs[i] = -static_cast<float>(tot[kUpper + i]);
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    int p = c;
    float best = fabsf(A[c][c]);
#pragma unroll
    for (int i = 0; i < 6; ++i)
      if (i > c && fabsf(A[i][c]) > best) {
        best = fabsf(A[i][c]);
        p = i;
      }
#pragma unroll
    for (int i = 0; i < 6; ++i)
      if (i > c && i == p) {
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const float t = A[c][j];
          A[c][j] = A[i][j];
          A[i][j] = t;
        }
        const float t = rhs[c];
        rhs[c] = rhs[i];
        rhs[i] = t;
      }
    if (A[c][c] != 0.0f) {
      const float inv = 1.0f / A[c][c];
#pragma unroll
      for (int i = 0; i < 6; ++i)
        if (i > c) A[i][c] = A[i][c] * inv;
    }
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j)
        if (i > c && j > c) A[i][j] = fmaf(-A[i][c], A[c][j], A[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j)
      if (j < i) rhs[i] = fmaf(-A[i][j], rhs[j], rhs[i]);
#pragma unroll
  for (int i = 5; i >= 0; --i) {
#pragma unroll
    for (int j = 0; j < 6; ++j)
      if (j > i) rhs[i] = fmaf(-A[i][j], rhs[j], rhs[i]);
    rhs[i] = rhs[i] / A[i][i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) dx[i] = rhs[i];
}

__device__ __forceinline__ Pose load_pose(const float* s) {
  Pose T;
  for (int k = 0; k < 4; ++k) T.q[k] = s[k];
  for (int k = 0; k < 3; ++k) T.t[k] = s[4 + k];
  return T;
}

__device__ __forceinline__ void store_pose(const Pose& T, float* s) {
  for (int k = 0; k < 4; ++k) s[k] = T.q[k];
  for (int k = 0; k < 3; ++k) s[4 + k] = T.t[k];
}

__global__ void __launch_bounds__(kThreads, 1) pose_opt_kernel(Args a) {
  __shared__ double red[kWarps][32];
  __shared__ double tot[32];
  __shared__ float pose[7];
  __shared__ float cand[7];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid < 7) pose[tid] = a.tcw0[tid];
  for (int i = tid; i < a.n; i += kThreads) a.inlier[i] = a.valid[i] ? 1 : 0;
  __syncthreads();

  for (int round = 0; round < a.rounds; ++round) {
    const bool use_huber = round < 2;  // the reference drops it at round 3
    for (int it = 0; it < a.iters; ++it) {
      const Pose T = load_pose(pose);
      Sums s;
#pragma unroll
      for (int k = 0; k < kUpper; ++k) s.h[k] = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) s.g[k] = 0.0f;
      s.cost = 0.0;
      for (int i = tid; i < a.n; i += kThreads)
        accumulate(a, T, load_point(a, i), a.inlier[i], use_huber, s);

      double v[32];
#pragma unroll
      for (int k = 0; k < kUpper; ++k) v[k] = s.h[k];
#pragma unroll
      for (int k = 0; k < 6; ++k) v[kUpper + k] = s.g[k];
      v[kSums - 1] = s.cost;
#pragma unroll
      for (int k = kSums; k < 32; ++k) v[k] = 0.0;
      red[warp][lane] = warp_transpose_sum(v, lane);
      __syncthreads();
      if (warp == 0) {
        double x = red[0][lane];
        for (int w = 1; w < kWarps; ++w) x += red[w][lane];
        tot[lane] = x;
        __syncwarp();
        if (lane == 0) {
          float dx[6];
          solve6(tot, dx);
          Pose E, Tn;
          se3_exp(dx, E);
          se3_compose(E, T, Tn);
          store_pose(Tn, a.guarded ? cand : pose);
        }
      }
      __syncthreads();
      if (!a.guarded) continue;

      // The guarded step: keep the new pose only if the robust cost fell.
      const Pose Tn = load_pose(cand);
      double c = 0.0;
      for (int i = tid; i < a.n; i += kThreads) {
        const Point p = load_point(a, i);
        float pc[3], r[3], invz;
        const float chi2 = residual(a, Tn, p, pc, r, invz);
        const float hw = use_huber ? huber(chi2, p.delta2) : 1.0f;
        c += static_cast<double>(chi2 * hw * (a.inlier[i] ? 1.0f : 0.0f));
      }
      const double c_new = block_sum(c, &red[0][0]);
      if (tid == 0 && c_new < tot[kSums - 1]) store_pose(Tn, pose);
      __syncthreads();
    }
    // Gate: inlier = valid & chi2(pose) <= delta2, each thread its points.
    const Pose T = load_pose(pose);
    for (int i = tid; i < a.n; i += kThreads) {
      const Point p = load_point(a, i);
      float pc[3], r[3], invz;
      const float chi2 = residual(a, T, p, pc, r, invz);
      a.inlier[i] = (a.valid[i] && chi2 <= p.delta2) ? 1 : 0;
    }
  }

  double count = 0.0;
  for (int i = tid; i < a.n; i += kThreads) count += a.inlier[i];
  count = block_sum(count, &red[0][0]);
  if (tid == 0) *a.n_inliers = static_cast<long long>(count);
  if (tid < 7) a.tcw[tid] = pose[tid];
}

}  // namespace

// The C entry point the Python wrapper binds with ctypes: one launch on
// `stream`, nothing allocated, no synchronisation. Returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int sgslam_pose_opt(const void* tcw0, const void* pw,
                               const void* obs, const void* inv_sigma2,
                               const void* valid, int n, float fx, float fy,
                               float cx, float cy, float bf, int rounds,
                               int iters, int guarded, float chi2_mono,
                               float chi2_stereo, void* tcw, void* inlier,
                               void* n_inliers, void* stream) {
  Args a;
  a.tcw0 = static_cast<const float*>(tcw0);
  a.pw = static_cast<const float*>(pw);
  a.obs = static_cast<const float*>(obs);
  a.inv_sigma2 = static_cast<const float*>(inv_sigma2);
  a.valid = static_cast<const uint8_t*>(valid);
  a.tcw = static_cast<float*>(tcw);
  a.inlier = static_cast<uint8_t*>(inlier);
  a.n_inliers = static_cast<long long*>(n_inliers);
  a.n = n;
  a.fx = fx;
  a.fy = fy;
  a.cx = cx;
  a.cy = cy;
  a.bf = bf;
  a.rounds = rounds;
  a.iters = iters;
  a.guarded = guarded;
  a.chi2_mono = chi2_mono;
  a.chi2_stereo = chi2_stereo;
  pose_opt_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
