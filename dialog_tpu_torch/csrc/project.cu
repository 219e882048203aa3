// The projection search's glue on each side of kernel B: project_gate before
// it, invert_matches after it.
//
// Replaces no Pallas kernel: the JAX package leaves these steps
// (dialog_tpu/tracking.py::_project_landmarks, the local-map search's
// "already" mask, match_projected's radius, and the per-feature inversion of
// the matches in _motion_match and track_local_map_match) to XLA, which fuses
// them into the search's one program. Written out in PyTorch they are
// about 50 small launches a search, three searches a tracked frame, and the
// host's cost of launching them sets the tracking step's pace on the card.
//
// project_gate, one thread per row n of ids (N rows, L landmark slots):
//
//   s = clamp(ids[n], 0, L - 1); ok = 0 <= ids[n] < L & valid[s]
//   Xc = R xyz[s] + t; z = Xc.z; zs = |z| < 1e-9 ? 1e-9 : z
//   uv = (fx Xc.x / zs + cx, fy Xc.y / zs + cy)
//   ray = xyz[s] - (-R^T t); dist = |ray|
//   octave = clamp(ceil(log(max(dmax[s] / max(dist, 1e-6), 1e-6)) / log(sf) - 1e-4), 0, n_levels - 1)
//   vis = ok & z > 1e-3 & 0 <= u < width & 0 <= v < height
//   FRUSTUM: vis &= ray.normal[s] / max(dist, 1e-9) > view_cos_th
//                   & dist >= 0.8 dmin[s] & dist <= 1.2 dmax[s]
//   radius2 = (radius sf^octave)^2; desc = desc[s]
//
// and, in the local-map form (MERGE: the frame's current lm_of_feat [F]),
// already = some feature holds landmark s: vis &= !already, seen = the
// frustum's vis | already, free[f] = feat_valid[f] & lm_of_feat[f] < 0. Every
// product, sum and quotient is float32 rounded once (__fmul_rn, __fadd_rn,
// __fdiv_rn: nvcc cannot contract them into an FMA), in the plain version's
// order; the logarithm is logf and sf^octave is rounded from float64.
//
// invert_matches, one block: out[f] = ids[n] for the last row n whose match is
// feature f (rows matching no feature in [0, F) are dropped), -1 where no row
// matches f or the id lies outside [0, L); with a prior lm_of_feat, features
// it already holds keep their landmark; count = features with a landmark.
//
// What bounds them on the H100: latency. project_gate moves ~80 bytes a row
// (N = 8,192: ~0.7 MB, 0.2 us at 3.35 TB/s) and invert_matches a few tens of
// KB; both are one launch where the plain version takes dozens. Design:
// project_gate reads R and t once per block into shared memory and copies a
// row's descriptor with two 16-byte loads; its "already" test is a hash set
// of the F current associations that each block builds in shared memory
// (open addressing, twice F slots, integer atomicCAS) and probes per row, so
// no L-sized scratch and no second launch. invert_matches runs in one block
// of 1,024 threads: integer atomicMax of the row index into out[] as scratch
// (the last writer, as ops.scatter_set rules), a barrier, then each thread
// turns its features' winning rows into ids, merges and counts, and the
// count is summed over the block in a fixed order. No float atomics: the
// same inputs give the same bits from run to run.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 256;            // project_gate's threads a block
constexpr int NT_INV = 1024;       // invert_matches' one block
constexpr int EMPTY = -1;

struct Store {
  const float* xyz;
  const int* desc;
  const float* dmax;
  const uint8_t* valid;
  const float* normal;
  const float* dmin;
  int L;
};

struct Cam {
  float fx, fy, cx, cy, width, height, scale_factor, view_cos_th, radius;
  int n_levels;
};

struct Outs {
  int* desc;
  float* uv;
  int* octave;
  uint8_t* vis;
  float* radius2;
  uint8_t* seen;
  uint8_t* free_;
};

// the key's slot: a 32-bit finalizer (MurmurHash3's), so that every bit of the key moves the low bits
__device__ __forceinline__ unsigned slot_of(int key, unsigned mask) {
  unsigned h = static_cast<unsigned>(key);
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h & mask;
}

__device__ __forceinline__ void set_insert(int* tab, unsigned mask, int key) {
  for (unsigned h = slot_of(key, mask);; h = (h + 1) & mask) {
    const int prev = atomicCAS(&tab[h], EMPTY, key);
    if (prev == EMPTY || prev == key) return;
  }
}

__device__ __forceinline__ bool set_has(const int* tab, unsigned mask, int key) {
  for (unsigned h = slot_of(key, mask);; h = (h + 1) & mask) {
    const int v = tab[h];
    if (v == key) return true;
    if (v == EMPTY) return false;
  }
}

template <bool FRUSTUM, bool MERGE>
__global__ void __launch_bounds__(NT) project_gate_kernel(const int* __restrict__ ids, int n, Store st,
                                                          const float* __restrict__ R, const float* __restrict__ t,
                                                          Cam cam, const int* __restrict__ lm_of_feat,
                                                          const uint8_t* __restrict__ feat_valid, int F,
                                                          unsigned tab_mask, Outs out) {
  extern __shared__ int tab[];     // MERGE: the hash set of lm_of_feat's landmarks in [0, L)
  __shared__ float pose[12];       // R row-major, then t
  const int tid = threadIdx.x;
  if (tid < 9) pose[tid] = R[tid];
  else if (tid < 12) pose[tid] = t[tid - 9];
  if constexpr (MERGE) {
    for (unsigned k = tid; k <= tab_mask; k += NT) tab[k] = EMPTY;
    const int f = blockIdx.x * NT + tid;
    if (f < F) out.free_[f] = feat_valid[f] && lm_of_feat[f] < 0;
  }
  __syncthreads();
  if constexpr (MERGE) {
    for (int f = tid; f < F; f += NT) {
      const int v = lm_of_feat[f];
      if (v >= 0 && v < st.L) set_insert(tab, tab_mask, v);
    }
    __syncthreads();
  }
  const int i = blockIdx.x * NT + tid;
  if (i >= n) return;

  const int id = ids[i];
  const int s = min(max(id, 0), st.L - 1);
  const bool ok = id >= 0 && id < st.L && st.valid[s];
  const float X0 = st.xyz[3 * s], X1 = st.xyz[3 * s + 1], X2 = st.xyz[3 * s + 2];
  const float* p = pose;
  float xc[3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
    xc[r] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(p[3 * r], X0), __fmul_rn(p[3 * r + 1], X1)),
                                __fmul_rn(p[3 * r + 2], X2)),
                      p[9 + r]);
  const float z = xc[2];
  const float zs = fabsf(z) < 1e-9f ? 1e-9f : z;
  const float u = __fadd_rn(__fdiv_rn(__fmul_rn(cam.fx, xc[0]), zs), cam.cx);
  const float v = __fadd_rn(__fdiv_rn(__fmul_rn(cam.fy, xc[1]), zs), cam.cy);
  const bool inb = u >= 0.0f && u < cam.width && v >= 0.0f && v < cam.height;
  float ray[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    // the camera centre -R^T t, as (-R^T) t
    const float cc = __fadd_rn(__fadd_rn(__fmul_rn(-p[c], p[9]), __fmul_rn(-p[3 + c], p[10])),
                               __fmul_rn(-p[6 + c], p[11]));
    ray[c] = __fsub_rn(c == 0 ? X0 : (c == 1 ? X1 : X2), cc);
  }
  const float dist = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(ray[0], ray[0]), __fmul_rn(ray[1], ray[1])),
                                          __fmul_rn(ray[2], ray[2])));
  const float dmax = st.dmax[s];
  const float ratio = fmaxf(__fdiv_rn(dmax, fmaxf(dist, 1e-6f)), 1e-6f);
  const float lvl = ceilf(__fsub_rn(__fdiv_rn(logf(ratio), logf(cam.scale_factor)), 1e-4f));
  const int octave = static_cast<int>(fminf(fmaxf(lvl, 0.0f), static_cast<float>(cam.n_levels - 1)));
  bool vis = ok && z > 1e-3f && inb;
  if constexpr (FRUSTUM) {
    const float dot = __fadd_rn(__fadd_rn(__fmul_rn(ray[0], st.normal[3 * s]), __fmul_rn(ray[1], st.normal[3 * s + 1])),
                                __fmul_rn(ray[2], st.normal[3 * s + 2]));
    const float cos_view = __fdiv_rn(dot, fmaxf(dist, 1e-9f));
    vis = vis && cos_view > cam.view_cos_th && dist >= __fmul_rn(0.8f, st.dmin[s]) && dist <= __fmul_rn(1.2f, dmax);
  }
  if constexpr (MERGE) {
    const bool already = set_has(tab, tab_mask, s);
    out.seen[i] = vis || already;
    vis = vis && !already;
  }
  const double scale = pow(static_cast<double>(cam.scale_factor), static_cast<double>(octave));
  const float r = __fmul_rn(cam.radius, static_cast<float>(scale));
  const int4* src = reinterpret_cast<const int4*>(st.desc + 8 * static_cast<long long>(s));
  int4* dst = reinterpret_cast<int4*>(out.desc + 8 * static_cast<long long>(i));
  dst[0] = src[0];
  dst[1] = src[1];
  reinterpret_cast<float2*>(out.uv)[i] = make_float2(u, v);
  out.octave[i] = octave;
  out.vis[i] = vis;
  out.radius2[i] = __fmul_rn(r, r);
}

__global__ void __launch_bounds__(NT_INV) invert_matches_kernel(const int* __restrict__ match_ft,
                                                               const int* __restrict__ ids, int n, int F, int L,
                                                               const int* __restrict__ prior, int* __restrict__ out,
                                                               long long* __restrict__ count) {
  __shared__ int part[NT_INV / 32];
  const int tid = threadIdx.x;
  for (int f = tid; f < F; f += NT_INV) out[f] = -1;
  __syncthreads();
  for (int i = tid; i < n; i += NT_INV) {
    const int f = match_ft[i];
    if (f >= 0 && f < F) atomicMax(&out[f], i);
  }
  __syncthreads();
  int cnt = 0;
  for (int f = tid; f < F; f += NT_INV) {
    const int w = out[f];
    int v = w >= 0 ? ids[w] : -1;
    if (v < 0 || v >= L) v = -1;
    if (prior != nullptr && prior[f] >= 0) v = prior[f];
    out[f] = v;
    cnt += v >= 0;
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) cnt += __shfl_down_sync(0xffffffffu, cnt, m);
  if ((tid & 31) == 0) part[tid >> 5] = cnt;
  __syncthreads();
  if (tid == 0) {
    long long total = 0;
    for (int w = 0; w < NT_INV / 32; ++w) total += part[w];
    *count = total;
  }
}

template <bool FRUSTUM, bool MERGE>
cudaError_t launch_gate(int blocks, size_t smem, cudaStream_t s, const int* ids, int n, const Store& st,
                        const float* R, const float* t, const Cam& cam, const int* lm, const uint8_t* fv, int F,
                        unsigned mask, const Outs& o) {
  auto kernel = project_gate_kernel<FRUSTUM, MERGE>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, NT, smem, s>>>(ids, n, st, R, t, cam, lm, fv, F, mask, o);
  return cudaGetLastError();
}

}  // namespace

// tab_slots: the hash set's size in the local-map form (a power of two at
// least 2 F), 0 without lm_of_feat: seen and free_ are written only in that form.
extern "C" int project_gate_launch(const void* ids, int n, const void* xyz, const void* desc, const void* dmax,
                                   const void* valid, const void* normal, const void* dmin, int L, const void* R,
                                   const void* t, float fx, float fy, float cx, float cy, float width,
                                   float height, float scale_factor, int n_levels, float view_cos_th,
                                   float radius, int frustum, const void* lm_of_feat, const void* feat_valid,
                                   int F, int tab_slots, void* desc_out, void* uv_out, void* octave_out,
                                   void* vis_out, void* radius2_out, void* seen_out, void* free_out,
                                   void* stream) {
  const bool merge = tab_slots > 0;
  if (n < 0 || L <= 0 || n_levels <= 0 || (frustum && (normal == nullptr || dmin == nullptr)) ||
      (merge && (F < 0 || tab_slots < 2 * F || (tab_slots & (tab_slots - 1)) != 0 || (n > 0 && seen_out == nullptr) ||
                 (F > 0 && (lm_of_feat == nullptr || feat_valid == nullptr || free_out == nullptr)))))
    return static_cast<int>(cudaErrorInvalidValue);
  const Store st{static_cast<const float*>(xyz), static_cast<const int*>(desc), static_cast<const float*>(dmax),
                 static_cast<const uint8_t*>(valid), static_cast<const float*>(normal),
                 static_cast<const float*>(dmin), L};
  const Cam cam{fx, fy, cx, cy, width, height, scale_factor, view_cos_th, radius, n_levels};
  const Outs o{static_cast<int*>(desc_out), static_cast<float*>(uv_out), static_cast<int*>(octave_out),
               static_cast<uint8_t*>(vis_out), static_cast<float*>(radius2_out), static_cast<uint8_t*>(seen_out),
               static_cast<uint8_t*>(free_out)};
  const int rows = merge ? (n > F ? n : F) : n;
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (rows + NT - 1) / NT;
  const size_t smem = merge ? sizeof(int) * static_cast<size_t>(tab_slots) : 0;
  const unsigned mask = merge ? static_cast<unsigned>(tab_slots - 1) : 0u;
  auto s = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const int*>(ids);
  auto Rf = static_cast<const float*>(R), tf = static_cast<const float*>(t);
  auto lm = static_cast<const int*>(lm_of_feat);
  auto fv = static_cast<const uint8_t*>(feat_valid);
  cudaError_t err;
  if (frustum)
    err = merge ? launch_gate<true, true>(blocks, smem, s, i, n, st, Rf, tf, cam, lm, fv, F, mask, o)
                : launch_gate<true, false>(blocks, smem, s, i, n, st, Rf, tf, cam, lm, fv, F, mask, o);
  else
    err = merge ? launch_gate<false, true>(blocks, smem, s, i, n, st, Rf, tf, cam, lm, fv, F, mask, o)
                : launch_gate<false, false>(blocks, smem, s, i, n, st, Rf, tf, cam, lm, fv, F, mask, o);
  return static_cast<int>(err);
}

extern "C" int invert_matches_launch(const void* match_ft, const void* ids, int n, int F, int L, const void* prior,
                                     void* out, void* count, void* stream) {
  if (n < 0 || F < 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  invert_matches_kernel<<<1, NT_INV, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(match_ft), static_cast<const int*>(ids), n, F, L, static_cast<const int*>(prior),
      static_cast<int*>(out), static_cast<long long*>(count));
  return static_cast<int>(cudaGetLastError());
}
