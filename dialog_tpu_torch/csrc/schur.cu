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

#include <cuda_runtime.h>

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

__global__ void schur_pass1(const float* __restrict__ R, const float* __restrict__ T,
                            const unsigned char* __restrict__ cam_opt,
                            const float* __restrict__ xyz, const int* __restrict__ obs_cam,
                            const float* __restrict__ obs_uv, const float* __restrict__ obs_w,
                            const float* __restrict__ lam_ptr, float fx, float fy, float cx,
                            float cy, float delta2, int C, int P, int O,
                            float* __restrict__ hll_inv_out, float* __restrict__ gl_out,
                            float* __restrict__ y_out, float* __restrict__ part) {
  __shared__ ObsRec rec[TP * MAXO];
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * TP;
  const float lam = *lam_ptr;

  if (tid < TP) {
    const int p = p0 + tid;
    ObsRec* my = rec + tid * MAXO;
    if (p >= P) {
      for (int o = 0; o < O; ++o) my[o].cam = -1;
    } else {
      const float X = xyz[p * 3], Yw = xyz[p * 3 + 1], Zw = xyz[p * 3 + 2];
      float h00 = 0.f, h01 = 0.f, h02 = 0.f, h11 = 0.f, h12 = 0.f, h22 = 0.f;
      float g0 = 0.f, g1 = 0.f, g2 = 0.f;
      for (int o = 0; o < O; ++o) {
        ObsRec& q = my[o];
        const int c = obs_cam[p * O + o];
        const float wi = obs_w[p * O + o];
        q.cam = -1;
        q.w = 0.f;
        q.rx = q.ry = 0.f;
        for (int k = 0; k < 6; ++k) q.Ju[k] = q.Jv[k] = 0.f;
        for (int k = 0; k < 3; ++k) q.Jlu[k] = q.Jlv[k] = 0.f;
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
        const float chi2 = (rx * rx + ry * ry) * wi;
        const float wr = (chi2 <= delta2) ? 1.f : sqrtf(delta2 / fmaxf(chi2, 1e-12f));
        const float w = wi * wr;
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
        h00 += w * (q.Jlu[0] * q.Jlu[0] + q.Jlv[0] * q.Jlv[0]);
        h01 += w * (q.Jlu[0] * q.Jlu[1] + q.Jlv[0] * q.Jlv[1]);
        h02 += w * (q.Jlu[0] * q.Jlu[2] + q.Jlv[0] * q.Jlv[2]);
        h11 += w * (q.Jlu[1] * q.Jlu[1] + q.Jlv[1] * q.Jlv[1]);
        h12 += w * (q.Jlu[1] * q.Jlu[2] + q.Jlv[1] * q.Jlv[2]);
        h22 += w * (q.Jlu[2] * q.Jlu[2] + q.Jlv[2] * q.Jlv[2]);
        g0 += w * (q.Jlu[0] * rx + q.Jlv[0] * ry);
        g1 += w * (q.Jlu[1] * rx + q.Jlv[1] * ry);
        g2 += w * (q.Jlu[2] * rx + q.Jlv[2] * ry);
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
        ObsRec& q = my[o];
        float Yo[6][3];
        for (int i = 0; i < 6; ++i)
          for (int k = 0; k < 3; ++k)
            Yo[i][k] = q.w * (q.Ju[i] * q.Jlu[k] + q.Jv[i] * q.Jlv[k]);
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
      const ObsRec* lr = rec + lp * MAXO;
      for (int o = 0; o < O; ++o) {
        const ObsRec& q = lr[o];
        if (q.cam != c) continue;
        for (int j = 0; j < 6; ++j) hacc[j] += q.w * (q.Ju[i] * q.Ju[j] + q.Jv[i] * q.Jv[j]);
        gacc += q.w * (q.Ju[i] * q.rx + q.Jv[i] * q.ry);
        racc += q.gred[i];
        for (int o2 = 0; o2 < O; ++o2) {
          const ObsRec& q2 = lr[o2];
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

extern "C" int schur_reduce_launch(const void* R, const void* t, const void* cam_opt,
                                   const void* xyz, const void* obs_cam, const void* obs_uv,
                                   const void* obs_w, const void* lam, float fx, float fy,
                                   float cx, float cy, float delta2, int C, int P, int O,
                                   void* hll_inv, void* g_l, void* Y, void* part,
                                   void* cam_out, void* stream) {
  if (O > MAXO || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_blocks = schur_num_blocks(P);
  const int n_out = 36 * C * C + 48 * C;
  if (n_blocks > 0) {
    schur_pass1<<<n_blocks, NT, 0, s>>>(
        static_cast<const float*>(R), static_cast<const float*>(t),
        static_cast<const unsigned char*>(cam_opt), static_cast<const float*>(xyz),
        static_cast<const int*>(obs_cam), static_cast<const float*>(obs_uv),
        static_cast<const float*>(obs_w), static_cast<const float*>(lam), fx, fy, cx, cy,
        delta2, C, P, O, static_cast<float*>(hll_inv), static_cast<float*>(g_l),
        static_cast<float*>(Y), static_cast<float*>(part));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  schur_pass2<<<(n_out + 255) / 256, 256, 0, s>>>(static_cast<const float*>(part), n_blocks,
                                                 n_out, static_cast<float*>(cam_out));
  return static_cast<int>(cudaGetLastError());
}
