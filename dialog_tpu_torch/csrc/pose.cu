// Pose LM: motion-only bundle adjustment of one frame, every round and
// iteration of optim/pose_only.pose_optimization in one launch.
//
// Replaces no Pallas kernel: the JAX package leaves this function
// (dialog_tpu/optim/pose_only.py::pose_optimization) to XLA, which runs it as
// one fused program. Written out in PyTorch, the same loop is about 2,100
// small launches a call, and the host's cost of launching them sets the
// tracking step's pace on the card. Inputs: the start pose R0 [3,3], t0 [3],
// the points X [N,3], the observed pixels uv [N,2], their information
// weights w_obs [N], valid [N] and, in the stereo form, the right-x u_right
// [N] (< 0: a monocular observation). Outputs: R, t, the final inlier set,
// its size and the last round's robust cost. The algorithm, as the plain
// version runs it:
//
//   R = orth(R0); inlier = valid
//   per round: R = orth(R); base = inlier; (cost, H, g) = system(R, t, base)
//     per iteration, lam from 1e-3:
//       dx = -(H + lam diag(max(H_ii, 1e-9)))^-1 g; (R', t') = exp(dx) o (R, t)
//       accept when cost' < cost and R', t' are finite: take (R', t'), H', g';
//       lam x0.5 on accept, x4 on reject, clamped to [1e-9, 1e6]
//     inlier = valid & z > 1e-3 & chi2 <= chi2_th at the round's pose
//
// with orth two Newton steps towards SO(3), system() the Huber-weighted
// normal equations of the observations in base in front of the camera
// (z > 1e-3): two rows (u, v), or in the stereo form (D = 3) a third, uR,
// where u_right >= 0.
//
// What bounds it on the H100: latency. The data is a few tens of KB and the
// arithmetic a few MFLOP; a call is a chain of rounds x (iters + 1) passes
// over the observations and rounds re-gates, each pass followed by a
// block-wide sum and a serial 6x6 solve. Design: one block of NT threads;
// observation i belongs to thread i % NT for the whole call, so its base
// flag lives in the output inlier[i], read and written by that thread alone.
// The per-observation terms (residual, gate, Huber weight and rho, the Dx6
// Jacobian) are float32, as the plain version computes them; the 21 + 6 + 1
// sums (upper H, g, cost) are float64 in each thread, then over each warp by
// a shuffle tree, then over the warps in order by the first 28 lanes of warp
// 0. Thread 0 keeps the accepted state in shared memory and takes the
// damped solve (Cholesky: the damped system is SPD; a pivot that is not
// positive gives a non-finite step, which the finite test rejects, as the
// plain version's LU without its status check does), the retraction and
// both orthogonalizations in float64, rounding the pose to float32. Two
// block barriers a pass. No float atomics: the same inputs give the same
// bits from run to run.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 256;           // threads of the one block
constexpr int NW = NT / 32;
constexpr int NS = 28;            // H upper triangle (21), g (6), cost
constexpr unsigned FULL = 0xffffffffu;

struct Cam {
  float fx, fy, cx, cy, bf, chi2_th;
};

struct Inputs {
  const float* X;
  const float* uv;
  const float* w_obs;
  const uint8_t* valid;
  const float* u_right;
  int n;
};

// The residual rows of observation i at the pose p (R row-major, then t), its
// depth gate and chi2; with JAC the pose Jacobian rows too (wrt the
// left-multiplicative twist (rho, phi)). The stereo row and its Jacobian are
// zero where u_right < 0.
template <int D, bool JAC>
__device__ __forceinline__ void observe(const float* p, const Inputs& in, const Cam& c, int i, float r[D],
                                        float J[D][6], bool& front, float& chi2) {
  const float X0 = in.X[3 * i], X1 = in.X[3 * i + 1], X2 = in.X[3 * i + 2];
  const float x = p[0] * X0 + p[1] * X1 + p[2] * X2 + p[9];
  const float y = p[3] * X0 + p[4] * X1 + p[5] * X2 + p[10];
  const float z = p[6] * X0 + p[7] * X1 + p[8] * X2 + p[11];
  front = z > 1e-3f;
  const float iz = 1.0f / (fabsf(z) < 1e-9f ? 1e-9f : z);
  const float iz2 = iz * iz;
  const float u = c.fx * x * iz + c.cx;
  r[0] = u - in.uv[2 * i];
  r[1] = c.fy * y * iz + c.cy - in.uv[2 * i + 1];
  bool st = false;
  if constexpr (D == 3) {
    const float ur = in.u_right[i];
    st = ur >= 0.0f;
    r[2] = st ? (u - c.bf * iz) - ur : 0.0f;
  }
  float s = r[0] * r[0] + r[1] * r[1];
  if constexpr (D == 3) s += r[2] * r[2];
  chi2 = s * in.w_obs[i];
  if constexpr (JAC) {
    const float a = c.fx * iz, cc = -c.fx * x * iz2;
    const float b = c.fy * iz, d = -c.fy * y * iz2;
    J[0][0] = a;    J[0][1] = 0.0f; J[0][2] = cc;
    J[0][3] = cc * y;         J[0][4] = a * z - cc * x; J[0][5] = -a * y;
    J[1][0] = 0.0f; J[1][1] = b;    J[1][2] = d;
    J[1][3] = -b * z + d * y; J[1][4] = -d * x;         J[1][5] = b * x;
    if constexpr (D == 3) {
      const float c2 = cc + c.bf * iz2;
      J[2][0] = st ? a : 0.0f;      J[2][1] = 0.0f;                   J[2][2] = st ? c2 : 0.0f;
      J[2][3] = st ? c2 * y : 0.0f; J[2][4] = st ? a * z - c2 * x : 0.0f; J[2][5] = st ? -a * y : 0.0f;
    }
  }
}

// This thread's share of (H upper, g, cost) over the observations in base at
// the pose p, in float64.
template <int D>
__device__ __forceinline__ void system_terms(const float* p, const Inputs& in, const Cam& c, const uint8_t* base,
                                             double acc[NS]) {
#pragma unroll
  for (int k = 0; k < NS; ++k) acc[k] = 0.0;
  for (int i = threadIdx.x; i < in.n; i += NT) {
    if (!base[i]) continue;
    float r[D], J[D][6], chi2;
    bool front;
    observe<D, true>(p, in, c, i, r, J, front, chi2);
    if (!front) continue;
    const float d2 = c.chi2_th;
    const float safe = fmaxf(chi2, 1e-12f);
    const bool inner = chi2 <= d2;
    const float w = in.w_obs[i] * (inner ? 1.0f : sqrtf(d2 / safe));
    const float rho = inner ? chi2 : 2.0f * sqrtf(d2 * safe) - d2;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      double wJ[6];
#pragma unroll
      for (int a = 0; a < 6; ++a) wJ[a] = static_cast<double>(w) * J[k][a];
      int idx = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int b = a; b < 6; ++b) acc[idx++] += wJ[a] * J[k][b];
      }
#pragma unroll
      for (int a = 0; a < 6; ++a) acc[21 + a] += wJ[a] * r[k];
    }
    acc[27] += rho;
  }
}

// The block's sums of acc in a fixed order, left in out[NS] for warp 0 (no
// barrier after: thread 0 reads them after its own warp's __syncwarp).
__device__ __forceinline__ void block_sum(double acc[NS], double (*part)[NS], double* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) acc[k] += __shfl_down_sync(FULL, acc[k], m);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NS; ++k) part[warp][k] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x < NS) {
    double s = part[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < NW; ++w) s += part[w][threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncwarp();
}

// R <- R (1.5 I - 0.5 R^T R), twice, in float64; p holds R row-major.
__device__ void orthogonalize(float* p) {
  double R[9];
  for (int k = 0; k < 9; ++k) R[k] = p[k];
  for (int it = 0; it < 2; ++it) {
    double M[9], N[9];
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) {
        double s = 0.0;
        for (int k = 0; k < 3; ++k) s += R[3 * k + a] * R[3 * k + b];
        M[3 * a + b] = (a == b ? 1.5 : 0.0) - 0.5 * s;
      }
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) {
        double s = 0.0;
        for (int k = 0; k < 3; ++k) s += R[3 * a + k] * M[3 * k + b];
        N[3 * a + b] = s;
      }
    for (int k = 0; k < 9; ++k) R[k] = N[k];
  }
  for (int k = 0; k < 9; ++k) p[k] = static_cast<float>(R[k]);
}

// dx = -(H + lam diag(max(H_ii, 1e-9)))^-1 g by Cholesky in float64; s holds
// H's upper triangle row by row, then g. A pivot that is not positive gives NaN.
__device__ void damped_step(const double* s, float lam, double dx[6]) {
  double A[6][6];
  int idx = 0;
  for (int a = 0; a < 6; ++a)
    for (int b = a; b < 6; ++b) A[a][b] = A[b][a] = s[idx++];
  for (int a = 0; a < 6; ++a) A[a][a] += static_cast<double>(lam) * (A[a][a] > 1e-9 ? A[a][a] : 1e-9);
  double L[6][6];
  for (int j = 0; j < 6; ++j) {
    double d = A[j][j];
    for (int k = 0; k < j; ++k) d -= L[j][k] * L[j][k];
    if (!(d > 0.0)) {
      for (int a = 0; a < 6; ++a) dx[a] = __longlong_as_double(0x7ff8000000000000ll);
      return;
    }
    L[j][j] = sqrt(d);
    for (int i = j + 1; i < 6; ++i) {
      double v = A[i][j];
      for (int k = 0; k < j; ++k) v -= L[i][k] * L[j][k];
      L[i][j] = v / L[j][j];
    }
  }
  double y[6];
  for (int i = 0; i < 6; ++i) {
    double v = -s[21 + i];
    for (int k = 0; k < i; ++k) v -= L[i][k] * y[k];
    y[i] = v / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    double v = y[i];
    for (int k = i + 1; k < 6; ++k) v -= L[k][i] * dx[k];
    dx[i] = v / L[i][i];
  }
}

// (R', t') = exp(dx) o (R, t), dx = (rho, phi): Rodrigues with the plain
// version's small-angle branch (geometry.so3_exp, se3_exp), in float64,
// rounded into q. Returns whether q is finite.
__device__ bool retract(const float* p, const double dx[6], float* q) {
  const double r0 = dx[0], r1 = dx[1], r2 = dx[2], w0 = dx[3], w1 = dx[4], w2 = dx[5];
  const double th2 = w0 * w0 + w1 * w1 + w2 * w2;
  const double th = sqrt(th2 + 1e-16);
  const bool small = th2 < 1e-8;
  double sn, cs;
  sincos(th, &sn, &cs);
  const double a = small ? 1.0 - th2 / 6.0 : sn / th;
  const double b = small ? 0.5 - th2 / 24.0 : (1.0 - cs) / th2;
  const double c = small ? 1.0 / 6.0 - th2 / 120.0 : (th - sn) / (th2 * th);
  const double W[9] = {0.0, -w2, w1, w2, 0.0, -w0, -w1, w0, 0.0};
  double W2[9], dR[9], Jl[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double s = 0.0;
      for (int k = 0; k < 3; ++k) s += W[3 * i + k] * W[3 * k + j];
      W2[3 * i + j] = s;
    }
  for (int k = 0; k < 9; ++k) {
    const double I = (k % 4 == 0) ? 1.0 : 0.0;
    dR[k] = I + a * W[k] + b * W2[k];
    Jl[k] = I + b * W[k] + c * W2[k];
  }
  const double rho[3] = {r0, r1, r2};
  bool finite = true;
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      double s = 0.0;
      for (int k = 0; k < 3; ++k) s += dR[3 * i + k] * static_cast<double>(p[3 * k + j]);
      q[3 * i + j] = static_cast<float>(s);
      finite = finite && isfinite(q[3 * i + j]);
    }
    double s = 0.0;
    for (int k = 0; k < 3; ++k) s += dR[3 * i + k] * static_cast<double>(p[9 + k]) + Jl[3 * i + k] * rho[k];
    q[9 + i] = static_cast<float>(s);
    finite = finite && isfinite(q[9 + i]);
  }
  return finite;
}

template <int D>
__global__ void __launch_bounds__(NT) pose_lm_kernel(const float* __restrict__ R0, const float* __restrict__ t0,
                                                     Inputs in, Cam cam, int rounds, int iters,
                                                     float* __restrict__ R_out, float* __restrict__ t_out,
                                                     uint8_t* __restrict__ inlier, long long* __restrict__ n_out,
                                                     float* __restrict__ cost_out) {
  __shared__ double part[NW][NS];
  __shared__ double sums[NS];   // the last pass's sums (warp 0)
  __shared__ double cur[NS];    // the accepted pose's sums (thread 0)
  __shared__ float x[12];       // the accepted pose (thread 0)
  __shared__ float pose[12];    // the pose the next pass evaluates
  __shared__ int counts[NW];
  const int tid = threadIdx.x;

  for (int i = tid; i < in.n; i += NT) inlier[i] = in.valid[i];
  if (tid == 0) {
    for (int k = 0; k < 9; ++k) x[k] = R0[k];
    for (int k = 0; k < 3; ++k) x[9 + k] = t0[k];
    orthogonalize(x);
    cur[27] = 0.0;
  }
  double acc[NS];
  for (int round = 0; round < rounds; ++round) {
    if (tid == 0) {
      orthogonalize(x);
      for (int k = 0; k < 12; ++k) pose[k] = x[k];
    }
    __syncthreads();
    system_terms<D>(pose, in, cam, inlier, acc);
    block_sum(acc, part, sums);
    float lam = 1e-3f;   // thread 0's
    if (tid == 0) {
      for (int k = 0; k < NS; ++k) cur[k] = sums[k];
    }
    for (int it = 0; it < iters; ++it) {
      bool finite = false;
      if (tid == 0) {
        double dx[6];
        damped_step(cur, lam, dx);
        finite = retract(x, dx, pose);
      }
      __syncthreads();
      system_terms<D>(pose, in, cam, inlier, acc);
      block_sum(acc, part, sums);
      if (tid == 0) {
        const bool accept = sums[27] < cur[27] && finite;
        if (accept) {
          for (int k = 0; k < 12; ++k) x[k] = pose[k];
          for (int k = 0; k < NS; ++k) cur[k] = sums[k];
        }
        lam = fminf(fmaxf(accept ? lam * 0.5f : lam * 4.0f, 1e-9f), 1e6f);
      }
    }
    // the chi2 re-gate at the round's pose
    if (tid == 0) {
      for (int k = 0; k < 12; ++k) pose[k] = x[k];
    }
    __syncthreads();
    for (int i = tid; i < in.n; i += NT) {
      float r[D], J[D][6], chi2;
      bool front;
      observe<D, false>(pose, in, cam, i, r, J, front, chi2);
      inlier[i] = in.valid[i] && front && chi2 <= cam.chi2_th;
    }
    __syncthreads();
  }

  int cnt = 0;
  for (int i = tid; i < in.n; i += NT) cnt += inlier[i];
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) cnt += __shfl_down_sync(FULL, cnt, m);
  if ((tid & 31) == 0) counts[tid >> 5] = cnt;
  __syncthreads();
  if (tid == 0) {
    long long total = 0;
    for (int w = 0; w < NW; ++w) total += counts[w];
    *n_out = total;
    for (int k = 0; k < 9; ++k) R_out[k] = x[k];
    for (int k = 0; k < 3; ++k) t_out[k] = x[9 + k];
    *cost_out = static_cast<float>(cur[27]);
  }
}

}  // namespace

extern "C" int pose_lm_launch(const void* R0, const void* t0, const void* X, const void* uv, const void* w_obs,
                              const void* valid, const void* u_right, int n, float fx, float fy, float cx,
                              float cy, float bf, float chi2_th, int rounds, int iters, int stereo, void* R_out,
                              void* t_out, void* inlier, void* n_out, void* cost_out, void* stream) {
  if (n < 0 || rounds < 0 || iters < 0 || (stereo && n > 0 && u_right == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Inputs in{static_cast<const float*>(X), static_cast<const float*>(uv), static_cast<const float*>(w_obs),
                  static_cast<const uint8_t*>(valid), static_cast<const float*>(u_right), n};
  const Cam cam{fx, fy, cx, cy, bf, chi2_th};
  auto s = static_cast<cudaStream_t>(stream);
  auto R0f = static_cast<const float*>(R0), t0f = static_cast<const float*>(t0);
  auto Ro = static_cast<float*>(R_out), to = static_cast<float*>(t_out), co = static_cast<float*>(cost_out);
  auto io = static_cast<uint8_t*>(inlier);
  auto no = static_cast<long long*>(n_out);
  if (stereo)
    pose_lm_kernel<3><<<1, NT, 0, s>>>(R0f, t0f, in, cam, rounds, iters, Ro, to, io, no, co);
  else
    pose_lm_kernel<2><<<1, NT, 0, s>>>(R0f, t0f, in, cam, rounds, iters, Ro, to, io, no, co);
  return static_cast<int>(cudaGetLastError());
}
