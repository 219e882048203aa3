// Kernel B: gated best / second-best 256-bit Hamming match per query row.
//
// Replaces the Pallas kernel dialog_tpu/kernels/hamming.py::hamming_best2
// (body _kernel). For each row i of A and every column j of B:
//
//   d(i, j) = popcount(A_i xor B_j)            if valid_a[i] & valid_b[j]
//                                              & spatial gate & octave gate
//           = 257                              otherwise
//   spatial gate: r2 = r2_rows[i] if r2_rows[i] >= 0 else r2_cols[j];
//                 open if r2 < 0, else |uv_a[i] - uv_b[j]|^2 <= r2
//   octave gate:  open if band < 0, else |oct_a[i] - oct_b[j]| <= band
//
// and returns (argmin or -1, min, second-min excluding the argmin), ties to
// the lowest column.
//
// What bounds it on the H100: at N = 2048, M = 1024 the work is 2M pairs of
// 8 popcounts (~16M integer ops) over ~100 KB of inputs, far below both the
// memory and the integer roofline, so it is launch- and latency-bound.
// Design: one warp per A-row, eight rows per block; the B side streams
// through shared memory in chunks of 256 columns shared by the block's rows.
// Each lane scans its columns in increasing order keeping (best, index,
// second); the warp then merges the 32 partial results with shuffles,
// comparing (distance, column) pairs, so ties go to the lowest column.
// The TPU's f32 min-key encoding is gone: integers compare directly. The
// gate's squared distance is computed with __fmul_rn/__fadd_rn so nvcc cannot
// contract it into an FMA, which would round differently from the plain
// version at the gate boundary. The result is bit-exact.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_DIST = 257;
constexpr int ROWS = 8;       // warps (= query rows) per block
constexpr int CHUNK = 256;    // B columns staged per step

struct Best2 {
  int best, idx, second;
};

__device__ __forceinline__ void push(Best2& r, int d, int j) {
  // columns arrive in increasing order per lane: strict < keeps the lowest
  if (d < r.best) {
    r.second = r.best;
    r.best = d;
    r.idx = j;
  } else if (d < r.second) {
    r.second = d;
  }
}

__global__ void hamming_best2_kernel(
    const uint32_t* __restrict__ desc_a, const uint32_t* __restrict__ desc_b,
    const uint8_t* __restrict__ valid_a, const uint8_t* __restrict__ valid_b,
    const float* __restrict__ uv_a, const float* __restrict__ uv_b,
    const float* __restrict__ r2_rows, const float* __restrict__ r2_cols,
    const int* __restrict__ oct_a, const int* __restrict__ oct_b, int band,
    int N, int M, int* __restrict__ idx_out, int* __restrict__ best_out,
    int* __restrict__ second_out) {
  __shared__ uint32_t sdesc[CHUNK][9];   // padded row: no bank conflicts
  __shared__ float sux[CHUNK], suy[CHUNK], sr2c[CHUNK];
  __shared__ int soct[CHUNK];
  __shared__ uint8_t svalid[CHUNK];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS + warp;
  const bool live = row < N;

  uint32_t a[8];
  float ax = 0.f, ay = 0.f, r2r = -1.f;
  int oa = 0;
  bool va = false;
  if (live) {
#pragma unroll
    for (int w = 0; w < 8; ++w) a[w] = desc_a[row * 8 + w];
    ax = uv_a[row * 2];
    ay = uv_a[row * 2 + 1];
    r2r = r2_rows[row];
    oa = oct_a[row];
    va = valid_a[row] != 0;
  }
  Best2 r{MAX_DIST, INT_MAX, MAX_DIST};

  for (int base = 0; base < M; base += CHUNK) {
    const int n = min(CHUNK, M - base);
    __syncthreads();
    for (int i = threadIdx.x; i < n * 8; i += blockDim.x)
      sdesc[i >> 3][i & 7] = desc_b[base * 8 + i];
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      sux[i] = uv_b[(base + i) * 2];
      suy[i] = uv_b[(base + i) * 2 + 1];
      sr2c[i] = r2_cols[base + i];
      soct[i] = oct_b[base + i];
      svalid[i] = valid_b[base + i];
    }
    __syncthreads();
    if (!live) continue;
    for (int jj = lane; jj < n; jj += 32) {
      int d = MAX_DIST;
      if (va && svalid[jj]) {
        float dx = ax - sux[jj];
        float dy = ay - suy[jj];
        float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        float r2 = (r2r >= 0.f) ? r2r : sr2c[jj];
        bool sp_ok = (r2 < 0.f) || (d2 <= r2);
        bool oct_ok = (band < 0) || (abs(oa - soct[jj]) <= band);
        if (sp_ok && oct_ok) {
          int pc = 0;
#pragma unroll
          for (int w = 0; w < 8; ++w) pc += __popc(a[w] ^ sdesc[jj][w]);
          d = pc;
        }
      }
      push(r, d, base + jj);
    }
  }
  if (!live) return;

  // warp merge of per-lane (best, idx, second) over disjoint column sets:
  // union best = lexicographic min of (best, idx); union second =
  // min(second_winner, best_loser) = min(s1, s2, max(b1, b2))
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    int ob = __shfl_down_sync(0xffffffffu, r.best, off);
    int oi = __shfl_down_sync(0xffffffffu, r.idx, off);
    int os = __shfl_down_sync(0xffffffffu, r.second, off);
    int sec = min(min(r.second, os), max(r.best, ob));
    if (ob < r.best || (ob == r.best && oi < r.idx)) {
      r.best = ob;
      r.idx = oi;
    }
    r.second = sec;
  }
  if (lane == 0) {
    idx_out[row] = (r.best >= MAX_DIST) ? -1 : r.idx;
    best_out[row] = r.best;
    second_out[row] = r.second;
  }
}

}  // namespace

extern "C" int hamming_best2_launch(
    const void* desc_a, const void* desc_b, const void* valid_a,
    const void* valid_b, const void* uv_a, const void* uv_b,
    const void* r2_rows, const void* r2_cols, const void* oct_a,
    const void* oct_b, int band, int N, int M, void* idx, void* best,
    void* second, void* stream) {
  dim3 grid((N + ROWS - 1) / ROWS);
  hamming_best2_kernel<<<grid, ROWS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(desc_a), static_cast<const uint32_t*>(desc_b),
      static_cast<const uint8_t*>(valid_a), static_cast<const uint8_t*>(valid_b),
      static_cast<const float*>(uv_a), static_cast<const float*>(uv_b),
      static_cast<const float*>(r2_rows), static_cast<const float*>(r2_cols),
      static_cast<const int*>(oct_a), static_cast<const int*>(oct_b), band, N, M,
      static_cast<int*>(idx), static_cast<int*>(best), static_cast<int*>(second));
  return static_cast<int>(cudaGetLastError());
}
