// Kernel C: fused BA Jacobian accumulation + Schur reduction, one LM step.
//
// Replaces the Pallas kernel dialog_tpu/kernels/schur.py::schur_reduce
// (body _kernel; plain form optim/local_ba.py::_reduce_jnp). Inputs: camera
// poses R [C,3,3], t [C,3], cam_opt [C], landmarks xyz [P,3], observations
// bucketed per landmark obs_cam [P,O] (outside [0,C): none), obs_uv [P,O,2],
// information weights obs_w [P,O] (0: none), the LM damping lam (device
// scalar), and the index of the live slots by camera (cam_ptr [C+1],
// cam_obs [P*O], flat p*O+o in increasing order within a camera; built once
// per problem by kernels/schur.py::camera_index). Per landmark p and
// observation o:
//
//   residual r = pi(R_c X_p + t_c) - uv, analytic Jacobians J_c (2x6, zero
//   for frozen cameras) and J_l (2x3), Huber weight w (delta2),
//   Hll = sum_o J_l^T w J_l, g_l = sum_o J_l^T w r,
//   Hll^-1 from the Cholesky factor of the damped block,
//   Y_o = J_c^T w J_l.
// Camera side: Hcc[c] = sum J_c^T w J_c, g_c[c] = sum J_c^T w r,
//   g_red[c] = sum Y Hll^-1 g_l, S_pair[c,:,d,:] = sum_p Y_po Hll^-1 Y_po'^T.
//
// Frozen landmarks (lm_opt [P], may be null: all optimized): a landmark with
// lm_opt[p] == 0 has its J_l zeroed (the reference's einsum path,
// optim/local_ba.py::_reduce_jnp; the Pallas kernel has no such mode). Its
// Hll is then the damping alone, its g_l, Y, Z and its share of g_red and
// S_pair are zero, and its observations still add to Hcc and g_c as
// pose-only edges. Its slots leave S_pair's lists (their Z is zero).
//
// Stereo variant (STEREO, the Pallas body's use_stereo): an observation with
// a right-x obs_ur >= 0 adds a third row
//   rw = fx x/z + cx - bf/z - uR,  chi2 = (rx^2 + ry^2 + rw^2) w_info with
//   Huber bound delta2_st (mono observations: two rows, delta2),
//   Jw = [a, 0, c2, c2 y, a z - c2 x, -a y], c2 = c + bf/z^2 (zero for
//   frozen cameras), Jlw = a R[0,:] + c2 R[2,:].
//
// What bounds it on the H100: nothing the card is short of. The inputs and
// outputs are a few MB (a few microseconds of memory traffic) and the
// arithmetic some tens of MFLOP, so the kernel's time is what its layout
// wastes: idle lanes, uncoalesced or repeated traffic, serial sums. Design:
//
//   schur_obs, one lane per observation slot, a group of G = 8, 16 or 32
//     lanes per landmark: residual, Jacobians and weight in the lane; Hll
//     and g_l summed over the group by a shuffle butterfly (every lane ends
//     with the same bits); every lane factors the damped block and forms its
//     own Y (staged in shared memory, so that the block writes its landmarks'
//     contiguous Y as whole lines), Z = Y L^-T (L the Cholesky factor, so
//     Hll^-1 = L^-T L^-1 and S_pair = sum Z Z^T), Y Hll^-1 g_l and its
//     J_c^T w J_c, J_c^T w r terms. Scratch, linear in the slots: the slot's
//     camera if it counts toward S_pair, else -1 (scam [P*O]); Z [P*O,18];
//     the 33 summands of Hcc (upper triangle), g_c and g_red field-major
//     (cterm [33,P*O], neighbouring lanes on neighbouring addresses).
//     Slots of one landmark that share a camera are merged: the first
//     carries the sum of their Z and the others leave S_pair's lists, so a
//     landmark holds at most one S_pair slot per camera.
//   schur_cams, the camera side in one launch of two kinds of block:
//     one per camera pair c <= d walks camera c's slots, finds the same
//     landmark's slot of camera d among its O slots, and adds Z_c Z_d^T (6x6)
//     in registers; it writes S_pair[c,:,d,:] and its transpose
//     S_pair[d,:,c,:] (frozen cameras' blocks write zeros);
//     one per (camera, field) sums the field of cterm over the camera's slots.
// Both kinds of block sum in a fixed order (a thread's slots in list
// order, the warp's lanes by butterfly, the warps in order) and write every
// output entry once: no float atomics, no per-block partials in global
// memory, and the same inputs give bitwise-equal outputs from run to run.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int NT_OBS = 128;    // threads per block, schur_obs
constexpr int NT_CAM = 128;    // threads per block, schur_cams
constexpr int N_TERMS = 33;    // Hcc upper triangle (21) + g_c (6) + g_red (6)
constexpr unsigned FULL = 0xffffffffu;

template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int m = G / 2; m > 0; m >>= 1) v += __shfl_xor_sync(FULL, v, m, G);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) { return group_sum<32>(v); }

template <bool STEREO, int G>
__global__ void __launch_bounds__(NT_OBS)
schur_obs(const float* __restrict__ R, const float* __restrict__ T,
          const unsigned char* __restrict__ cam_opt, const float* __restrict__ xyz,
          const int* __restrict__ obs_cam, const float* __restrict__ obs_uv,
          const float* __restrict__ obs_w, const float* __restrict__ obs_ur,
          const unsigned char* __restrict__ lm_opt, const float* __restrict__ lam_ptr, float fx,
          float fy, float cx, float cy, float delta2, float bf, float delta2_st, int C, int P, int O,
          float* __restrict__ hll_inv_out, float* __restrict__ gl_out, float* __restrict__ y_out,
          int* __restrict__ scam, float* __restrict__ Zs, float* __restrict__ cterm) {
  constexpr int NR = STEREO ? 3 : 2;           // residual rows: u, v and uR
  __shared__ __align__(8) float ybuf[NT_OBS * 18];   // the block's Y rows, in output order
  const int lane = threadIdx.x & 31;
  const int gid = blockIdx.x * (NT_OBS / G) + threadIdx.x / G;
  const int o = threadIdx.x % G;
  const bool active = gid < P && o < O;
  const int p = active ? gid : 0;
  const size_t n = (size_t)p * O + (active ? o : 0);
  const size_t N = (size_t)P * O;
  const float lam = *lam_ptr;

  int c = -1;
  float wi = 0.f;
  if (active) {
    c = obs_cam[n];
    wi = obs_w[n];
  }
  const bool slot = active && c >= 0 && c < C && wi > 0.f;   // a slot of the camera index
  const bool lm_free = lm_opt == nullptr || lm_opt[p] != 0;   // the landmark is optimized

  float r[NR], Jc[NR][6], Jl[NR][3];
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    r[k] = 0.f;
#pragma unroll
    for (int i = 0; i < 6; ++i) Jc[k][i] = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i) Jl[k][i] = 0.f;
  }
  float w = 0.f;
  bool counts = false;                         // adds to the camera-side outputs
  if (slot) {
    const float X = xyz[p * 3], Yw = xyz[p * 3 + 1], Zw = xyz[p * 3 + 2];
    const float* Rc = R + c * 9;
    const float* tc = T + c * 3;
    const float xc = Rc[0] * X + Rc[1] * Yw + Rc[2] * Zw + tc[0];
    const float yc = Rc[3] * X + Rc[4] * Yw + Rc[5] * Zw + tc[1];
    const float zc = Rc[6] * X + Rc[7] * Yw + Rc[8] * Zw + tc[2];
    if (zc > 1e-3f) {
      const float iz = 1.f / zc;
      const float iz2 = iz * iz;
      r[0] = fx * xc * iz + cx - obs_uv[n * 2];
      r[1] = fy * yc * iz + cy - obs_uv[n * 2 + 1];
      float r2 = r[0] * r[0] + r[1] * r[1];
      float d2 = delta2;
      bool has_ur = false;
      if constexpr (STEREO) {
        const float ur = obs_ur[n];
        has_ur = ur >= 0.f;
        if (has_ur) {
          r[2] = fx * xc * iz + cx - bf * iz - ur;
          r2 += r[2] * r[2];
          d2 = delta2_st;
        }
      }
      const float chi2 = r2 * wi;
      w = wi * ((chi2 <= d2) ? 1.f : sqrtf(d2 / fmaxf(chi2, 1e-12f)));
      const float a = fx * iz, cc = -fx * xc * iz2, b = fy * iz, d = -fy * yc * iz2;
      counts = cam_opt[c] != 0;
      const float opt = counts ? 1.f : 0.f;
      Jc[0][0] = a * opt;
      Jc[0][2] = cc * opt;
      Jc[0][3] = -fx * xc * yc * iz2 * opt;
      Jc[0][4] = fx * (1.f + xc * xc * iz2) * opt;
      Jc[0][5] = -fx * yc * iz * opt;
      Jc[1][1] = b * opt;
      Jc[1][2] = d * opt;
      Jc[1][3] = -fy * (1.f + yc * yc * iz2) * opt;
      Jc[1][4] = fy * xc * yc * iz2 * opt;
      Jc[1][5] = fy * xc * iz * opt;
      if (lm_free) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          Jl[0][k] = a * Rc[k] + cc * Rc[6 + k];
          Jl[1][k] = b * Rc[3 + k] + d * Rc[6 + k];
        }
      }
      if constexpr (STEREO) {
        if (has_ur) {
          const float c2 = cc + bf * iz2;
          Jc[2][0] = a * opt;
          Jc[2][2] = c2 * opt;
          Jc[2][3] = c2 * yc * opt;
          Jc[2][4] = (a * zc - c2 * xc) * opt;
          Jc[2][5] = -a * yc * opt;
          if (lm_free) {
#pragma unroll
            for (int k = 0; k < 3; ++k) Jl[2][k] = a * Rc[k] + c2 * Rc[6 + k];
          }
        }
      }
    }
  }

  // landmark block and gradient: the lane's share, then the group's sum
  float h[6], g[3];
  {
    constexpr int HI[6] = {0, 0, 0, 1, 1, 2}, HJ[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < NR; ++k) s += Jl[k][HI[e]] * Jl[k][HJ[e]];
      h[e] = group_sum<G>(w * s);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < NR; ++k) s += Jl[k][i] * r[k];
      g[i] = group_sum<G>(w * s);
    }
  }
  const float h00 = h[0], h01 = h[1], h02 = h[2], h11 = h[3], h12 = h[4], h22 = h[5];
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
  if (active && o == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) hll_inv_out[p * 9 + a * 3 + b] = Hi[a][b];
#pragma unroll
    for (int a = 0; a < 3; ++a) gl_out[p * 3 + a] = g[a];
  }
  float hg[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) hg[a] = Hi[a][0] * g[0] + Hi[a][1] * g[1] + Hi[a][2] * g[2];
  // Lh = Li^T (upper triangular): Lh[j][k] = Li[k][j]
  const float Lh[3][3] = {{i11, i21, i31}, {0.f, i22, i32}, {0.f, 0.f, i33}};

  // the lane's own Y, Z = Y L^-T and camera-side summands
  float Z[18], gred[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float Yo[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < NR; ++q) s += Jc[q][i] * Jl[q][k];
      Yo[k] = w * s;
      if (active) ybuf[((threadIdx.x / G) * O + o) * 18 + i * 3 + k] = Yo[k];
    }
    gred[i] = Yo[0] * hg[0] + Yo[1] * hg[1] + Yo[2] * hg[2];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j <= k; ++j) s += Yo[j] * Lh[j][k];
      Z[i * 3 + k] = s;
    }
  }
  __syncthreads();
  {
    const int lm0 = blockIdx.x * (NT_OBS / G);
    const int pairs = min(NT_OBS / G, P - lm0) * O * 9;        // float2 words of this block's Y
    float2* dst = reinterpret_cast<float2*>(y_out + (size_t)lm0 * O * 18);
    const float2* src = reinterpret_cast<const float2*>(ybuf);
    for (int i = threadIdx.x; i < pairs; i += NT_OBS) dst[i] = src[i];
  }
  if (slot) {
    int f = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = i; j < 6; ++j) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < NR; ++q) s += Jc[q][i] * Jc[q][j];
        cterm[(size_t)f * N + n] = w * s;
        ++f;
      }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < NR; ++q) s += Jc[q][i] * r[q];
      cterm[(size_t)(21 + i) * N + n] = w * s;
      cterm[(size_t)(27 + i) * N + n] = gred[i];
    }
  }

  // slots of this landmark that share a camera: the first takes the sum of
  // their Z (in lane order) and the others leave S_pair's lists
  const int key = counts ? (lane / G) * C + c : -1 - lane;
  const unsigned peers = __match_any_sync(FULL, key);
  const bool first = (__ffs(peers) - 1) == lane;
  if (__any_sync(FULL, counts && peers != (1u << lane))) {
    const int base = lane - o;
    for (int k = 1; k < G; ++k) {
      const int src = base + k;
      const bool take = counts && first && src != lane && ((peers >> src) & 1u);
#pragma unroll
      for (int e = 0; e < 18; ++e) {
        const float z = __shfl_sync(FULL, Z[e], src);
        if (take) Z[e] += z;
      }
    }
  }
  if (active) {
    scam[n] = (counts && first && lm_free) ? c : -1;
    if (counts && first && lm_free) {
#pragma unroll
      for (int e = 0; e < 18; ++e) Zs[n * 18 + e] = Z[e];
    }
  }
}

// A block for (camera c, field f of cterm): the field's sum over c's slots.
__device__ __forceinline__ void cam_terms_block(
    int c, int f, const unsigned char* __restrict__ cam_opt, const int* __restrict__ cam_ptr,
    const int* __restrict__ cam_obs, const float* __restrict__ cterm, size_t N,
    float* __restrict__ Hcc, float* __restrict__ g_c, float* __restrict__ g_red) {
  __shared__ float part[NT_CAM / 32];
  float s = 0.f;
  if (cam_opt[c]) {                              // frozen cameras: zero rows
    const float* src = cterm + (size_t)f * N;
    const int end = cam_ptr[c + 1];
    for (int k = cam_ptr[c] + threadIdx.x; k < end; k += NT_CAM) s += src[cam_obs[k]];
  }
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x != 0) return;
  float total = 0.f;
#pragma unroll
  for (int wp = 0; wp < NT_CAM / 32; ++wp) total += part[wp];
  if (f < 21) {
    int i = 0, rest = f;                         // f-th entry of the upper triangle, row by row
    while (rest >= 6 - i) {
      rest -= 6 - i;
      ++i;
    }
    const int j = i + rest;
    Hcc[c * 36 + i * 6 + j] = total;
    Hcc[c * 36 + j * 6 + i] = total;
  } else if (f < 27) {
    g_c[c * 6 + (f - 21)] = total;
  } else {
    g_red[c * 6 + (f - 27)] = total;
  }
}

// A block for the camera pair (c, d), c <= d: S_pair[c,:,d,:] = sum over the
// landmarks that both see of Z_c Z_d^T, and its transpose into S_pair[d,:,c,:].
__device__ __forceinline__ void pairs_block(
    int c, int d, const unsigned char* __restrict__ cam_opt, const int* __restrict__ cam_ptr,
    const int* __restrict__ cam_obs, const int* __restrict__ scam, const float* __restrict__ Zs,
    int C, int O, float* __restrict__ S) {
  __shared__ float part[NT_CAM / 32][36];
  if (d < c) return;
  float acc[36];
#pragma unroll
  for (int e = 0; e < 36; ++e) acc[e] = 0.f;
  if (cam_opt[c] && cam_opt[d]) {                // block-uniform
    const int end = cam_ptr[c + 1];
    for (int k = cam_ptr[c] + threadIdx.x; k < end; k += NT_CAM) {
      const int n = cam_obs[k];
      if (scam[n] != c) continue;
      int n2 = n;
      if (d != c) {
        const int base = (n / O) * O;
        n2 = -1;
        for (int o2 = 0; o2 < O; ++o2)
          if (scam[base + o2] == d) {
            n2 = base + o2;
            break;
          }
        if (n2 < 0) continue;
      }
      const float2* pa = reinterpret_cast<const float2*>(Zs + (size_t)n * 18);
      const float2* pb = reinterpret_cast<const float2*>(Zs + (size_t)n2 * 18);
      float za[18], zb[18];
#pragma unroll
      for (int e = 0; e < 9; ++e) {
        const float2 va = pa[e], vb = pb[e];
        za[2 * e] = va.x;
        za[2 * e + 1] = va.y;
        zb[2 * e] = vb.x;
        zb[2 * e + 1] = vb.y;
      }
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < 6; ++j)
          acc[i * 6 + j] += za[i * 3] * zb[j * 3] + za[i * 3 + 1] * zb[j * 3 + 1] +
                            za[i * 3 + 2] * zb[j * 3 + 2];
    }
#pragma unroll
    for (int e = 0; e < 36; ++e) {
      const float v = warp_sum(acc[e]);
      if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5][e] = v;
    }
  } else if (threadIdx.x < 32) {
    for (int e = threadIdx.x; e < 36 * (NT_CAM / 32); e += 32) (&part[0][0])[e] = 0.f;
  }
  __syncthreads();
  if (threadIdx.x >= 36) return;
  const int e = threadIdx.x, i = e / 6, j = e % 6;
  float total = 0.f;
#pragma unroll
  for (int wp = 0; wp < NT_CAM / 32; ++wp) total += part[wp][e];
  S[((size_t)(c * 6 + i) * C + d) * 6 + j] = total;
  if (d != c) S[((size_t)(d * 6 + j) * C + c) * 6 + i] = total;
}

// Grid (C, C + N_TERMS): rows y < C are the camera pairs (x, y), the rest the fields.
__global__ void __launch_bounds__(NT_CAM)
schur_cams(const unsigned char* __restrict__ cam_opt, const int* __restrict__ cam_ptr,
           const int* __restrict__ cam_obs, const int* __restrict__ scam,
           const float* __restrict__ Zs, const float* __restrict__ cterm, size_t N, int C, int O,
           float* __restrict__ S, float* __restrict__ Hcc, float* __restrict__ g_c,
           float* __restrict__ g_red) {
  if (static_cast<int>(blockIdx.y) < C)
    pairs_block(blockIdx.x, blockIdx.y, cam_opt, cam_ptr, cam_obs, scam, Zs, C, O, S);
  else
    cam_terms_block(blockIdx.x, blockIdx.y - C, cam_opt, cam_ptr, cam_obs, cterm, N, Hcc, g_c, g_red);
}

template <bool STEREO, int G>
void launch_obs(int P, cudaStream_t s, const float* R, const float* T, const unsigned char* cam_opt,
                const float* xyz, const int* obs_cam, const float* obs_uv, const float* obs_w,
                const float* obs_ur, const unsigned char* lm_opt, const float* lam, float fx,
                float fy, float cx, float cy, float delta2, float bf, float delta2_st, int C, int O,
                float* hll_inv, float* g_l, float* Y, int* scam, float* Zs, float* cterm) {
  constexpr int per_block = NT_OBS / G;
  schur_obs<STEREO, G><<<(P + per_block - 1) / per_block, NT_OBS, 0, s>>>(
      R, T, cam_opt, xyz, obs_cam, obs_uv, obs_w, obs_ur, lm_opt, lam, fx, fy, cx, cy, delta2, bf,
      delta2_st, C, P, O, hll_inv, g_l, Y, scam, Zs, cterm);
}

template <bool STEREO, typename... Args>
void launch_obs_for(int O, Args... args) {
  if (O <= 8)
    launch_obs<STEREO, 8>(args...);
  else if (O <= 16)
    launch_obs<STEREO, 16>(args...);
  else
    launch_obs<STEREO, 32>(args...);
}

}  // namespace

// 32-bit words of scratch per observation slot: Z (18) + cterm (33) + scam (1).
extern "C" int schur_scratch_words() { return 18 + N_TERMS + 1; }

// obs_ur (f32 [P, O]) is read only when stereo != 0, and may be null otherwise.
// lm_opt (bool [P]) may be null: every landmark optimized.
// scratch: P * O * schur_scratch_words() words. cam_out: S_pair [C,6,C,6],
// Hcc [C,6,6], g_c [C,6], g_red [C,6], one after the other.
extern "C" int schur_reduce_launch(const void* R, const void* t, const void* cam_opt,
                                   const void* xyz, const void* obs_cam, const void* obs_uv,
                                   const void* obs_w, const void* obs_ur, const void* lm_opt,
                                   const void* lam,
                                   const void* cam_ptr, const void* cam_obs, float fx, float fy,
                                   float cx, float cy, float delta2, float bf, float delta2_st,
                                   int stereo, int C, int P, int O, void* hll_inv, void* g_l,
                                   void* Y, void* scratch, void* cam_out, void* stream) {
  if (O <= 0 || O > 32 || C <= 0 || C > 65535 - N_TERMS || P < 0 || (stereo && obs_ur == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t N = (size_t)P * O;
  float* Zs = static_cast<float*>(scratch);       // first: its rows are read as float2
  float* cterm = Zs + 18 * N;
  int* scam = reinterpret_cast<int*>(cterm + N_TERMS * N);
  float* S = static_cast<float*>(cam_out);
  float* Hcc = S + (size_t)36 * C * C;
  float* g_c = Hcc + 36 * C;
  float* g_red = g_c + 6 * C;
  const unsigned char* opt = static_cast<const unsigned char*>(cam_opt);
  const int* ptr = static_cast<const int*>(cam_ptr);
  const int* obs = static_cast<const int*>(cam_obs);
  const unsigned char* lm_mask = static_cast<const unsigned char*>(lm_opt);
  if (P > 0) {
    if (stereo)
      launch_obs_for<true>(O, P, s, static_cast<const float*>(R), static_cast<const float*>(t), opt,
                           static_cast<const float*>(xyz), static_cast<const int*>(obs_cam),
                           static_cast<const float*>(obs_uv), static_cast<const float*>(obs_w),
                           static_cast<const float*>(obs_ur), lm_mask, static_cast<const float*>(lam), fx, fy,
                           cx, cy, delta2, bf, delta2_st, C, O, static_cast<float*>(hll_inv),
                           static_cast<float*>(g_l), static_cast<float*>(Y), scam, Zs, cterm);
    else
      launch_obs_for<false>(O, P, s, static_cast<const float*>(R), static_cast<const float*>(t), opt,
                            static_cast<const float*>(xyz), static_cast<const int*>(obs_cam),
                            static_cast<const float*>(obs_uv), static_cast<const float*>(obs_w),
                            static_cast<const float*>(nullptr), lm_mask, static_cast<const float*>(lam), fx,
                            fy, cx, cy, delta2, 0.f, 0.f, C, O, static_cast<float*>(hll_inv),
                            static_cast<float*>(g_l), static_cast<float*>(Y), scam, Zs, cterm);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  schur_cams<<<dim3(C, C + N_TERMS), NT_CAM, 0, s>>>(opt, ptr, obs, scam, Zs, cterm, N, C, O, S, Hcc,
                                                     g_c, g_red);
  return static_cast<int>(cudaGetLastError());
}
