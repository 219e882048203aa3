// Kernel C: fused BA Jacobian accumulation + Schur reduction, one LM step.
//
// Replaces the Pallas kernel dialog_tpu/kernels/schur.py::schur_reduce
// (body _kernel; plain form optim/local_ba.py::_reduce_jnp). Inputs: camera
// poses R [C,3,3], t [C,3], cam_opt [C], landmarks xyz [P,3], observations
// bucketed per landmark obs_cam [P,O] (>= C: none), obs_uv [P,O,2] and
// information weights obs_w [P,O] (0: none), the LM damping lam (device
// scalar). Per landmark p and observation o:
//
//   residual r = pi(R_c X_p + t_c) - uv, analytic Jacobians J_c (2x6, zero
//   for frozen cameras) and J_l (2x3), Huber weight w (delta2),
//   Hll = sum_o J_l^T w J_l, g_l = sum_o J_l^T w r,
//   Hll^-1 from the Cholesky factor of the damped block,
//   Y_o = J_c^T w J_l.
// Camera side: Hcc[c] = sum J_c^T w J_c, g_c[c] = sum J_c^T w r,
//   g_red[c] = sum Y Hll^-1 g_l, S_pair[c,:,d,:] = sum_p Y_po Hll^-1 Y_po'^T.
//
// What bounds it on the H100: at C = 32, P = 2048, O = 8 the arithmetic is
// a few tens of MFLOP and the inputs ~0.3 MB; the largest traffic is the
// per-block S_pair partials (one [6C, 6C] slab per block) and their final
// reduction, so it is latency- and launch-bound. Design:
//   pass 1, one block per TP landmarks: first one thread per landmark
//     computes its observations' Jacobians and weights (kept in shared
//     memory), Hll, its damped Cholesky inverse, g_l, Y (written out) and
//     the per-observation camera terms Y Hll^-1 g_l and Y L^-T (L: Cholesky
//     factor, so Hll^-1 = L^-T L^-1 and S_pair = sum Z Z^T);
//     then one thread per camera row (c, i) sums that row of Hcc, g_c,
//     g_red and S_pair over the block's observations into the block's own
//     partial slab in global memory. Each row has exactly one writer.
//   pass 2, one thread per output entry, sums the block partials in block
//     order.
// No float atomics anywhere: the same inputs give bitwise-equal outputs
// from run to run. The TPU-only layout (lane-major planes, one-hot camera
// gathers/scatters, camera padding to 8, the MAX_CAMS VMEM cap) is gone.
//
// Stereo variant (schur_pass1<true>, the Pallas body's use_stereo): for an
// observation with a right-x obs_ur >= 0 a third row adds
//   rw = fx x/z + cx - bf/z - uR,  chi2 = (rx^2 + ry^2 + rw^2) w_info with
//   Huber bound delta2_st (mono observations: two rows, delta2),
//   Jw = [a, 0, c2, c2 y, a z - c2 x, -a y], c2 = c + bf/z^2 (zero for
//   frozen cameras), Jlw = a R[0,:] + c2 R[2,:],
// into Hll, g_l, Y, Hcc, g_c, g_red and S_pair. Its per-observation record
// (ObsRecStereo, 224 B) makes TP x MAXO records 57,344 B, above the 48 KB
// static shared-memory limit, so the stereo instance takes its records as
// dynamic shared memory (cudaFuncAttributeMaxDynamicSharedMemorySize), and
// the mono instance keeps its static 47,104 B and its arithmetic as it was.
// TP stays 16 in both: a smaller TP would multiply the per-block partial
// slabs, which at C = 64 are already the largest traffic (P/TP blocks x
// (36 C^2 + 48 C) floats: 308 MB at P = 8192).

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int TP = 16;        // landmarks per block in pass 1
constexpr int MAXO = 16;      // observations per landmark held in shared memory
constexpr int NT = 256;       // threads per block

struct ObsRec {
  int cam;                    // camera index, -1 when the observation adds nothing
  float w, rx, ry;
  float Ju[6], Jv[6];         // pose Jacobian rows (frozen cameras: zero)
  float Jlu[3], Jlv[3];       // point Jacobian rows
  float gred[6];              // Y Hll^-1 g_l
  float YL[18];               // Y L^-T (6x3)
};

struct ObsRecStereo : ObsRec {
  float rw;                   // uR residual (mono observations: zero)
  float Jw[6];                // uR pose row (frozen cameras, mono observations: zero)
  float Jlw[3];               // uR point row (mono observations: zero)
};

// Sums over an observation's residual rows (u, v, and uR for a stereo record):
// point x point (Hll), point x residual (g_l), pose x point (Y), pose x pose
// (Hcc), pose x residual (g_c). The stereo overloads add the uR row last.
__device__ __forceinline__ float rows_ll(const ObsRec& q, int i, int k) {
  return q.Jlu[i] * q.Jlu[k] + q.Jlv[i] * q.Jlv[k];
}
__device__ __forceinline__ float rows_ll(const ObsRecStereo& q, int i, int k) {
  return rows_ll(static_cast<const ObsRec&>(q), i, k) + q.Jlw[i] * q.Jlw[k];
}
__device__ __forceinline__ float rows_lr(const ObsRec& q, int k) {
  return q.Jlu[k] * q.rx + q.Jlv[k] * q.ry;
}
__device__ __forceinline__ float rows_lr(const ObsRecStereo& q, int k) {
  return rows_lr(static_cast<const ObsRec&>(q), k) + q.Jlw[k] * q.rw;
}
__device__ __forceinline__ float rows_cl(const ObsRec& q, int i, int k) {
  return q.Ju[i] * q.Jlu[k] + q.Jv[i] * q.Jlv[k];
}
__device__ __forceinline__ float rows_cl(const ObsRecStereo& q, int i, int k) {
  return rows_cl(static_cast<const ObsRec&>(q), i, k) + q.Jw[i] * q.Jlw[k];
}
__device__ __forceinline__ float rows_cc(const ObsRec& q, int i, int j) {
  return q.Ju[i] * q.Ju[j] + q.Jv[i] * q.Jv[j];
}
__device__ __forceinline__ float rows_cc(const ObsRecStereo& q, int i, int j) {
  return rows_cc(static_cast<const ObsRec&>(q), i, j) + q.Jw[i] * q.Jw[j];
}
__device__ __forceinline__ float rows_cr(const ObsRec& q, int i) {
  return q.Ju[i] * q.rx + q.Jv[i] * q.ry;
}
__device__ __forceinline__ float rows_cr(const ObsRecStereo& q, int i) {
  return rows_cr(static_cast<const ObsRec&>(q), i) + q.Jw[i] * q.rw;
}

template <bool STEREO>
__global__ void schur_pass1(const float* __restrict__ R, const float* __restrict__ T,
                            const unsigned char* __restrict__ cam_opt,
                            const float* __restrict__ xyz, const int* __restrict__ obs_cam,
                            const float* __restrict__ obs_uv, const float* __restrict__ obs_w,
                            const float* __restrict__ obs_ur,
                            const float* __restrict__ lam_ptr, float fx, float fy, float cx,
                            float cy, float delta2, float bf, float delta2_st, int C, int P, int O,
                            float* __restrict__ hll_inv_out, float* __restrict__ gl_out,
                            float* __restrict__ y_out, float* __restrict__ part) {
  using Rec = typename std::conditional<STEREO, ObsRecStereo, ObsRec>::type;
  extern __shared__ __align__(16) unsigned char dyn_smem[];   // stereo records (launch-sized)
  Rec* rec;
  if constexpr (STEREO) {
    rec = reinterpret_cast<Rec*>(dyn_smem);
  } else {
    __shared__ ObsRec static_rec[TP * MAXO];
    rec = static_rec;
  }
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * TP;
  const float lam = *lam_ptr;

  if (tid < TP) {
    const int p = p0 + tid;
    Rec* my = rec + tid * MAXO;
    if (p >= P) {
      for (int o = 0; o < O; ++o) my[o].cam = -1;
    } else {
      const float X = xyz[p * 3], Yw = xyz[p * 3 + 1], Zw = xyz[p * 3 + 2];
      float h00 = 0.f, h01 = 0.f, h02 = 0.f, h11 = 0.f, h12 = 0.f, h22 = 0.f;
      float g0 = 0.f, g1 = 0.f, g2 = 0.f;
      for (int o = 0; o < O; ++o) {
        Rec& q = my[o];
        const int c = obs_cam[p * O + o];
        const float wi = obs_w[p * O + o];
        q.cam = -1;
        q.w = 0.f;
        q.rx = q.ry = 0.f;
        for (int k = 0; k < 6; ++k) q.Ju[k] = q.Jv[k] = 0.f;
        for (int k = 0; k < 3; ++k) q.Jlu[k] = q.Jlv[k] = 0.f;
        if constexpr (STEREO) {
          q.rw = 0.f;
          for (int k = 0; k < 6; ++k) q.Jw[k] = 0.f;
          for (int k = 0; k < 3; ++k) q.Jlw[k] = 0.f;
        }
        if (c < 0 || c >= C || !(wi > 0.f)) continue;
        const float* Rc = R + c * 9;
        const float* tc = T + c * 3;
        const float xc = Rc[0] * X + Rc[1] * Yw + Rc[2] * Zw + tc[0];
        const float yc = Rc[3] * X + Rc[4] * Yw + Rc[5] * Zw + tc[1];
        const float zc = Rc[6] * X + Rc[7] * Yw + Rc[8] * Zw + tc[2];
        if (!(zc > 1e-3f)) continue;
        const float iz = 1.f / zc;
        const float iz2 = iz * iz;
        const float rx = fx * xc * iz + cx - obs_uv[(p * O + o) * 2];
        const float ry = fy * yc * iz + cy - obs_uv[(p * O + o) * 2 + 1];
        float r2 = rx * rx + ry * ry;
        float d2 = delta2;
        if constexpr (STEREO) {
          const float ur = obs_ur[p * O + o];
          if (ur >= 0.f) {
            q.rw = fx * xc * iz + cx - bf * iz - ur;
            r2 += q.rw * q.rw;
            d2 = delta2_st;
          }
        }
        const float chi2 = r2 * wi;
        const float w = wi * ((chi2 <= d2) ? 1.f : sqrtf(d2 / fmaxf(chi2, 1e-12f)));
        const float a = fx * iz, cc = -fx * xc * iz2, b = fy * iz, d = -fy * yc * iz2;
        const float opt = cam_opt[c] ? 1.f : 0.f;
        q.w = w;
        q.rx = rx;
        q.ry = ry;
        q.Ju[0] = a * opt;
        q.Ju[1] = 0.f;
        q.Ju[2] = cc * opt;
        q.Ju[3] = -fx * xc * yc * iz2 * opt;
        q.Ju[4] = fx * (1.f + xc * xc * iz2) * opt;
        q.Ju[5] = -fx * yc * iz * opt;
        q.Jv[0] = 0.f;
        q.Jv[1] = b * opt;
        q.Jv[2] = d * opt;
        q.Jv[3] = -fy * (1.f + yc * yc * iz2) * opt;
        q.Jv[4] = fy * xc * yc * iz2 * opt;
        q.Jv[5] = fy * xc * iz * opt;
        for (int k = 0; k < 3; ++k) {
          q.Jlu[k] = a * Rc[k] + cc * Rc[6 + k];
          q.Jlv[k] = b * Rc[3 + k] + d * Rc[6 + k];
        }
        if (cam_opt[c]) q.cam = c;
        if constexpr (STEREO) {
          if (obs_ur[p * O + o] >= 0.f) {
            const float c2 = cc + bf * iz2;
            q.Jw[0] = a * opt;
            q.Jw[1] = 0.f;
            q.Jw[2] = c2 * opt;
            q.Jw[3] = c2 * yc * opt;
            q.Jw[4] = (a * zc - c2 * xc) * opt;
            q.Jw[5] = -a * yc * opt;
            for (int k = 0; k < 3; ++k) q.Jlw[k] = a * Rc[k] + c2 * Rc[6 + k];
          }
        }
        h00 += w * rows_ll(q, 0, 0);
        h01 += w * rows_ll(q, 0, 1);
        h02 += w * rows_ll(q, 0, 2);
        h11 += w * rows_ll(q, 1, 1);
        h12 += w * rows_ll(q, 1, 2);
        h22 += w * rows_ll(q, 2, 2);
        g0 += w * rows_lr(q, 0);
        g1 += w * rows_lr(q, 1);
        g2 += w * rows_lr(q, 2);
      }
      // damped block and its closed-form Cholesky inverse Li = L^-1
      const float H00 = h00 + lam * fmaxf(h00, 1e-9f) + 1e-9f;
      const float H11 = h11 + lam * fmaxf(h11, 1e-9f) + 1e-9f;
      const float H22 = h22 + lam * fmaxf(h22, 1e-9f) + 1e-9f;
      const float l11 = sqrtf(fmaxf(H00, 1e-18f));
      const float l21 = h01 / l11;
      const float l31 = h02 / l11;
      const float l22 = sqrtf(fmaxf(H11 - l21 * l21, 1e-18f));
      const float l32 = (h12 - l31 * l21) / l22;
      const float l33 = sqrtf(fmaxf(H22 - l31 * l31 - l32 * l32, 1e-18f));
      const float i11 = 1.f / l11, i22 = 1.f / l22, i33 = 1.f / l33;
      const float i21 = -l21 * i11 * i22;
      const float i31 = (l21 * l32 - l31 * l22) * (i11 * i22 * i33);
      const float i32 = -l32 * i22 * i33;
      // Hll^-1 = Li^T Li
      float Hi[3][3];
      Hi[0][0] = i11 * i11 + i21 * i21 + i31 * i31;
      Hi[0][1] = Hi[1][0] = i21 * i22 + i31 * i32;
      Hi[0][2] = Hi[2][0] = i31 * i33;
      Hi[1][1] = i22 * i22 + i32 * i32;
      Hi[1][2] = Hi[2][1] = i32 * i33;
      Hi[2][2] = i33 * i33;
      for (int a = 0; a < 3; ++a)
        for (int b = 0; b < 3; ++b) hll_inv_out[p * 9 + a * 3 + b] = Hi[a][b];
      gl_out[p * 3] = g0;
      gl_out[p * 3 + 1] = g1;
      gl_out[p * 3 + 2] = g2;
      float hg[3];
      for (int a = 0; a < 3; ++a) hg[a] = Hi[a][0] * g0 + Hi[a][1] * g1 + Hi[a][2] * g2;
      // Lh = Li^T (upper triangular): Lh[j][k] = Li[k][j]
      const float Lh[3][3] = {{i11, i21, i31}, {0.f, i22, i32}, {0.f, 0.f, i33}};
      for (int o = 0; o < O; ++o) {
        Rec& q = my[o];
        float Yo[6][3];
        for (int i = 0; i < 6; ++i)
          for (int k = 0; k < 3; ++k) Yo[i][k] = q.w * rows_cl(q, i, k);
        float* yo = y_out + (size_t)(p * O + o) * 18;
        for (int i = 0; i < 6; ++i) {
          for (int k = 0; k < 3; ++k) yo[i * 3 + k] = Yo[i][k];
          q.gred[i] = Yo[i][0] * hg[0] + Yo[i][1] * hg[1] + Yo[i][2] * hg[2];
          for (int k = 0; k < 3; ++k) {
            float s = 0.f;
            for (int j = 0; j <= k; ++j) s += Yo[i][j] * Lh[j][k];
            q.YL[i * 3 + k] = s;
          }
        }
      }
    }
  }
  __syncthreads();

  // camera rows: thread (c, i) owns row c*6+i of every camera-side output
  const int n_rows = 6 * C;
  const int stride = 36 * C * C + 48 * C;
  float* S = part + (size_t)blockIdx.x * stride;
  float* Hcc = S + 36 * C * C;
  float* gc = Hcc + 36 * C;
  float* gr = gc + 6 * C;
  for (int row = tid; row < n_rows; row += NT) {
    const int c = row / 6, i = row % 6;
    float* Srow = S + (size_t)row * n_rows;
    for (int e = 0; e < n_rows; ++e) Srow[e] = 0.f;
    float hacc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float gacc = 0.f, racc = 0.f;
    for (int lp = 0; lp < TP; ++lp) {
      const Rec* lr = rec + lp * MAXO;
      for (int o = 0; o < O; ++o) {
        const Rec& q = lr[o];
        if (q.cam != c) continue;
        for (int j = 0; j < 6; ++j) hacc[j] += q.w * rows_cc(q, i, j);
        gacc += q.w * rows_cr(q, i);
        racc += q.gred[i];
        for (int o2 = 0; o2 < O; ++o2) {
          const Rec& q2 = lr[o2];
          if (q2.cam < 0) continue;
          float* dst = Srow + q2.cam * 6;
          for (int j = 0; j < 6; ++j)
            dst[j] += q.YL[i * 3] * q2.YL[j * 3] + q.YL[i * 3 + 1] * q2.YL[j * 3 + 1] +
                      q.YL[i * 3 + 2] * q2.YL[j * 3 + 2];
        }
      }
    }
    for (int j = 0; j < 6; ++j) Hcc[row * 6 + j] = hacc[j];
    gc[row] = gacc;
    gr[row] = racc;
  }
}

__global__ void schur_pass2(const float* __restrict__ part, int n_blocks, int n_out,
                            float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_out) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += part[(size_t)b * n_out + e];
  out[e] = s;
}

}  // namespace

extern "C" int schur_num_blocks(int P) { return (P + TP - 1) / TP; }

// obs_ur (f32 [P, O]) is read only when stereo != 0, and may be null otherwise.
extern "C" int schur_reduce_launch(const void* R, const void* t, const void* cam_opt,
                                   const void* xyz, const void* obs_cam, const void* obs_uv,
                                   const void* obs_w, const void* obs_ur, const void* lam,
                                   float fx, float fy, float cx, float cy, float delta2,
                                   float bf, float delta2_st, int stereo, int C, int P, int O,
                                   void* hll_inv, void* g_l, void* Y, void* part,
                                   void* cam_out, void* stream) {
  if (O > MAXO || C <= 0 || (stereo && obs_ur == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_blocks = schur_num_blocks(P);
  const int n_out = 36 * C * C + 48 * C;
  if (n_blocks > 0) {
    const float* Rf = static_cast<const float*>(R);
    if (stereo) {
      const int smem = static_cast<int>(TP * MAXO * sizeof(ObsRecStereo));
      cudaError_t err = cudaFuncSetAttribute(schur_pass1<true>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      schur_pass1<true><<<n_blocks, NT, smem, s>>>(
          Rf, static_cast<const float*>(t), static_cast<const unsigned char*>(cam_opt),
          static_cast<const float*>(xyz), static_cast<const int*>(obs_cam),
          static_cast<const float*>(obs_uv), static_cast<const float*>(obs_w),
          static_cast<const float*>(obs_ur), static_cast<const float*>(lam), fx, fy, cx, cy,
          delta2, bf, delta2_st, C, P, O, static_cast<float*>(hll_inv),
          static_cast<float*>(g_l), static_cast<float*>(Y), static_cast<float*>(part));
    } else {
      schur_pass1<false><<<n_blocks, NT, 0, s>>>(
          Rf, static_cast<const float*>(t), static_cast<const unsigned char*>(cam_opt),
          static_cast<const float*>(xyz), static_cast<const int*>(obs_cam),
          static_cast<const float*>(obs_uv), static_cast<const float*>(obs_w), nullptr,
          static_cast<const float*>(lam), fx, fy, cx, cy, delta2, 0.f, 0.f, C, P, O,
          static_cast<float*>(hll_inv), static_cast<float*>(g_l), static_cast<float*>(Y),
          static_cast<float*>(part));
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  schur_pass2<<<(n_out + 255) / 256, 256, 0, s>>>(static_cast<const float*>(part), n_blocks,
                                                 n_out, static_cast<float*>(cam_out));
  return static_cast<int>(cudaGetLastError());
}
