// Kernel B: gated best / second-best 256-bit Hamming match per query row, and
// the mutual match on the same gated matrix in one pass over it.
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
// the lowest column. An absent gate is a null pointer: null coordinates read
// as 0, null radii as -1 (open), null octaves as 0.
//
// The mutual mode also answers the transposed question, which column's best
// row is which, from the same pass: the gate is symmetric in the pair (the
// squared distance has the same bits for a - b and b - a, the octave gate is
// an absolute difference, validity is a product), so every open pair (i, j)
// puts the key (d << 23) | i into column j's cell with an integer atomicMin.
// The minimum is order-free, so the result is deterministic, and the packed
// key gives the lowest row among equal distances: the transposed call's
// lowest-column rule. A second, small launch applies the match test per row:
// a best column, best <= max_dist, best < ratio * second in f32 (one rounded
// product, no FMA, as the plain version computes it), and that column's best
// row is this row.
//
// What bounds it on the H100: at N = 2048, M = 1024 the work is 2M gated pairs
// (9 operations each, 25 more where the gates open) over ~150 KB of inputs, a
// fraction of a microsecond by either rate: launches and dependent memory
// round trips set the time. The design spends one round trip on the B side:
// a block of 16 warps copies all of B (49 bytes a column: descriptor,
// position, column radius, octave, validity) into dynamic shared memory with
// asynchronous 16-byte copies and one barrier, then each warp scans whole
// rows out of shared memory, a lane per column, columns in increasing order,
// and merges its lanes' (best, index, second) by shuffles comparing
// (distance, column), so ties go to the lowest column. The grid is one wave
// (a block per SM while the rows last, two where shared memory allows);
// warps stride over the rows. Up to 4,736 columns fit; beyond, the columns
// come in chunks of 2,368 through two buffers, the next chunk's copy in
// flight while the current one is scanned, one row per warp.
// A descriptor sits in shared memory as two 16-byte halves, the halves of
// columns 4-7 (mod 8) swapped, so that a quarter warp's 16-byte reads touch
// every bank once. The gate's squared distance is computed with
// __fmul_rn/__fadd_rn so nvcc cannot contract it into an FMA, which would
// round differently from the plain version at the gate boundary. The result
// is bit-exact.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_DIST = 257;
constexpr int WARPS = 16;             // warps (= query rows in flight) per block
constexpr int NT = WARPS * 32;
constexpr int COL_BYTES = 49;         // shared memory per staged column
constexpr int SMEM_MAX = 232448;      // dynamic shared memory a block can have
constexpr int WHOLE_MAX = SMEM_MAX / COL_BYTES / 16 * 16;       // columns, one buffer
constexpr int CHUNK = SMEM_MAX / (2 * COL_BYTES) / 16 * 16;     // columns per buffer of two
constexpr int ROW_BITS = 23;          // row index bits of a column key
constexpr unsigned NO_ROW = 0xffffffffu;

struct Best2 {
  int best, idx, second;
};

struct Args {
  const uint4* desc_a;      // [N] x 2 halves
  const uint4* desc_b;      // [M] x 2 halves
  const uint8_t* valid_a;
  const uint8_t* valid_b;
  const float2* uv_a;       // null: (0, 0)
  const float2* uv_b;
  const float* r2_rows;     // null: -1
  const float* r2_cols;     // null: -1
  const int* oct_a;         // null: 0
  const int* oct_b;
  int band, N, M;
  int cap;                  // columns per shared-memory buffer (a multiple of 16)
  int* idx_out;
  int* best_out;
  int* second_out;
  unsigned* col_key;        // mutual mode: [M], all ones on entry
};

// one buffer of staged columns
struct Stage {
  uint4* desc;      // [cap] x 2 halves, swizzled
  float2* uv;       // [cap]
  float* r2c;       // [cap]
  int* oct;         // [cap]
  uint8_t* valid;   // [cap]
};

__device__ __forceinline__ Stage stage_at(unsigned char* base, int cap) {
  Stage s;
  s.desc = reinterpret_cast<uint4*>(base);
  s.uv = reinterpret_cast<float2*>(base + (size_t)32 * cap);
  s.r2c = reinterpret_cast<float*>(base + (size_t)40 * cap);
  s.oct = reinterpret_cast<int*>(base + (size_t)44 * cap);
  s.valid = base + (size_t)48 * cap;
  return s;
}

// the 16-byte unit of half h of column j
__device__ __forceinline__ int desc_unit(int j, int h) { return 2 * j + (h ^ ((j >> 2) & 1)); }

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(BYTES) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Start the copy of columns [base, base + n) into a buffer, as one group of
// asynchronous copies per thread. Absent gates take their defaults by plain
// stores; validity is a byte a column, below the 4 bytes an asynchronous copy
// moves, and goes by plain loads.
__device__ __forceinline__ void stage_columns(const Args& p, const Stage& s, int base, int n) {
  for (int i = threadIdx.x; i < 2 * n; i += NT) {
    const int j = i >> 1, h = i & 1;
    cp_async<16>(&s.desc[desc_unit(j, h)], &p.desc_b[2 * (size_t)(base + j) + h]);
  }
  for (int j = threadIdx.x; j < n; j += NT) {
    if (p.uv_b) cp_async<8>(&s.uv[j], &p.uv_b[base + j]);
    else s.uv[j] = make_float2(0.f, 0.f);
    if (p.r2_cols) cp_async<4>(&s.r2c[j], &p.r2_cols[base + j]);
    else s.r2c[j] = -1.f;
    if (p.oct_b) cp_async<4>(&s.oct[j], &p.oct_b[base + j]);
    else s.oct[j] = 0;
  }
  cp_async_commit();
  for (int j = threadIdx.x; j < n; j += NT) s.valid[j] = p.valid_b[base + j];
}

struct Row {
  uint4 lo, hi;
  float ax, ay, r2r;
  int oa, row;
  bool valid;
};

__device__ __forceinline__ Row load_row(const Args& p, int row) {
  Row r;
  r.row = row;
  r.lo = p.desc_a[2 * (size_t)row];
  r.hi = p.desc_a[2 * (size_t)row + 1];
  const float2 uv = p.uv_a ? p.uv_a[row] : make_float2(0.f, 0.f);
  r.ax = uv.x;
  r.ay = uv.y;
  r.r2r = p.r2_rows ? p.r2_rows[row] : -1.f;
  r.oa = p.oct_a ? p.oct_a[row] : 0;
  r.valid = p.valid_a[row] != 0;
  return r;
}

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

// one lane's share of a row over the staged columns [base, base + n)
template <bool MUTUAL>
__device__ __forceinline__ void scan(const Args& p, const Stage& s, const Row& a, int base, int n,
                                     int lane, Best2& r) {
  if (!a.valid) return;   // every distance is MAX_DIST: nothing changes
  // four columns a step: their gates' loads are in flight together
  for (int j0 = lane; j0 < n; j0 += 128) {
    bool open[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int jj = j0 + 32 * u;
      const int jc = min(jj, n - 1);
      const uint8_t v = s.valid[jc];
      const float2 b = s.uv[jc];
      const float r2c = s.r2c[jc];
      const int ob = s.oct[jc];
      const float dx = a.ax - b.x;
      const float dy = a.ay - b.y;
      const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      const float r2 = (a.r2r >= 0.f) ? a.r2r : r2c;
      const bool sp_ok = (r2 < 0.f) || (d2 <= r2);
      const bool oct_ok = (p.band < 0) || (abs(a.oa - ob) <= p.band);
      open[u] = jj < n && v != 0 && sp_ok && oct_ok;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (!open[u]) continue;   // a closed pair's distance is MAX_DIST: nothing changes
      const int jj = j0 + 32 * u;
      const uint4 lo = s.desc[desc_unit(jj, 0)];
      const uint4 hi = s.desc[desc_unit(jj, 1)];
      const int d = __popc(a.lo.x ^ lo.x) + __popc(a.lo.y ^ lo.y) + __popc(a.lo.z ^ lo.z) + __popc(a.lo.w ^ lo.w) +
                    __popc(a.hi.x ^ hi.x) + __popc(a.hi.y ^ hi.y) + __popc(a.hi.z ^ hi.z) + __popc(a.hi.w ^ hi.w);
      if (MUTUAL) atomicMin(&p.col_key[base + jj], (static_cast<unsigned>(d) << ROW_BITS) | a.row);
      push(r, d, base + jj);
    }
  }
}

// warp merge of per-lane (best, idx, second) over disjoint column sets:
// union best = lexicographic min of (best, idx); union second =
// min(second_winner, best_loser) = min(s1, s2, max(b1, b2)); lane 0 writes
__device__ __forceinline__ void finish_row(const Args& p, int row, int lane, Best2 r) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ob = __shfl_down_sync(0xffffffffu, r.best, off);
    const int oi = __shfl_down_sync(0xffffffffu, r.idx, off);
    const int os = __shfl_down_sync(0xffffffffu, r.second, off);
    const int sec = min(min(r.second, os), max(r.best, ob));
    if (ob < r.best || (ob == r.best && oi < r.idx)) {
      r.best = ob;
      r.idx = oi;
    }
    r.second = sec;
  }
  if (lane == 0) {
    p.idx_out[row] = (r.best >= MAX_DIST) ? -1 : r.idx;
    p.best_out[row] = r.best;
    p.second_out[row] = r.second;
  }
}

template <bool MUTUAL>
__global__ void __launch_bounds__(NT, 2) hamming_scan_kernel(const __grid_constant__ Args p) {
  extern __shared__ uint4 smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (p.M <= p.cap) {
    // all of B in one buffer; warps stride over the rows
    const Stage s = stage_at(base, p.cap);
    stage_columns(p, s, 0, p.M);
    int row = blockIdx.x * WARPS + warp;
    Row a;
    if (row < p.N) a = load_row(p, row);   // in flight with the copies
    cp_async_wait<0>();
    __syncthreads();
    while (row < p.N) {
      Best2 r{MAX_DIST, INT_MAX, MAX_DIST};
      scan<MUTUAL>(p, s, a, 0, p.M, lane, r);
      finish_row(p, row, lane, r);
      row += gridDim.x * WARPS;
      if (row < p.N) a = load_row(p, row);
    }
    return;
  }

  // B in chunks through two buffers; one row per warp (the grid covers N)
  const size_t buffer_bytes = (size_t)COL_BYTES * p.cap;
  const int row = blockIdx.x * WARPS + warp;
  const bool live = row < p.N;
  Row a;
  a.valid = false;
  if (live) a = load_row(p, row);
  Best2 r{MAX_DIST, INT_MAX, MAX_DIST};
  const int n_chunks = (p.M + p.cap - 1) / p.cap;
  stage_columns(p, stage_at(base, p.cap), 0, min(p.cap, p.M));
  for (int c = 0; c < n_chunks; ++c) {
    const int at = c * p.cap;
    if (c + 1 < n_chunks) {
      stage_columns(p, stage_at(base + ((c + 1) & 1) * buffer_bytes, p.cap), at + p.cap, min(p.cap, p.M - at - p.cap));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // chunk c is in its buffer
    if (live) scan<MUTUAL>(p, stage_at(base + (c & 1) * buffer_bytes, p.cap), a, at, min(p.cap, p.M - at), lane, r);
    __syncthreads();   // before chunk c + 2 overwrites it
  }
  if (live) finish_row(p, row, lane, r);
}

// match_b[i] = the row's best column if it passes the match test, else -1
__global__ void hamming_mutual_kernel(const int* __restrict__ idx, const int* __restrict__ best,
                                      const int* __restrict__ second,
                                      const unsigned* __restrict__ col_key, int N, int max_dist,
                                      float ratio, int* __restrict__ match) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const int f = idx[row];
  const int b = best[row];
  bool ok = f >= 0 && b <= max_dist &&
            static_cast<float>(b) < __fmul_rn(ratio, static_cast<float>(second[row]));
  if (ok) {
    const unsigned key = col_key[f];
    ok = key != NO_ROW && static_cast<int>(key & ((1u << ROW_BITS) - 1u)) == row;
  }
  match[row] = ok ? f : -1;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <bool MUTUAL>
cudaError_t launch_scan(Args p, cudaStream_t s) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(hamming_scan_kernel<MUTUAL>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int rows_blocks = (p.N + WARPS - 1) / WARPS;
  int grid, smem;
  if (p.M <= WHOLE_MAX) {
    p.cap = max(16, (p.M + 15) / 16 * 16);
    smem = COL_BYTES * p.cap;
    const int per_sm = min(2, SMEM_MAX / (smem + 1024));
    grid = min(rows_blocks, sm_count() * max(per_sm, 1));
  } else {
    p.cap = CHUNK;
    smem = 2 * COL_BYTES * p.cap;
    grid = rows_blocks;
  }
  hamming_scan_kernel<MUTUAL><<<grid, NT, smem, s>>>(p);
  return cudaGetLastError();
}

Args make_args(const void* desc_a, const void* desc_b, const void* valid_a, const void* valid_b,
               const void* uv_a, const void* uv_b, const void* r2_rows, const void* r2_cols,
               const void* oct_a, const void* oct_b, int band, int N, int M, void* idx, void* best,
               void* second, void* col_key) {
  Args p;
  p.desc_a = static_cast<const uint4*>(desc_a);
  p.desc_b = static_cast<const uint4*>(desc_b);
  p.valid_a = static_cast<const uint8_t*>(valid_a);
  p.valid_b = static_cast<const uint8_t*>(valid_b);
  p.uv_a = static_cast<const float2*>(uv_a);
  p.uv_b = static_cast<const float2*>(uv_b);
  p.r2_rows = static_cast<const float*>(r2_rows);
  p.r2_cols = static_cast<const float*>(r2_cols);
  p.oct_a = static_cast<const int*>(oct_a);
  p.oct_b = static_cast<const int*>(oct_b);
  p.band = band;
  p.N = N;
  p.M = M;
  p.cap = 0;
  p.idx_out = static_cast<int*>(idx);
  p.best_out = static_cast<int*>(best);
  p.second_out = static_cast<int*>(second);
  p.col_key = static_cast<unsigned*>(col_key);
  return p;
}

}  // namespace

// uv_*, r2_*, oct_* may be null (see the head of the file); desc_* must be
// 16-byte aligned and uv_* 8-byte aligned.
extern "C" int hamming_best2_launch(const void* desc_a, const void* desc_b, const void* valid_a,
                                    const void* valid_b, const void* uv_a, const void* uv_b,
                                    const void* r2_rows, const void* r2_cols, const void* oct_a,
                                    const void* oct_b, int band, int N, int M,
                                    void* idx, void* best, void* second, void* stream) {
  if (N <= 0 || M < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args p = make_args(desc_a, desc_b, valid_a, valid_b, uv_a, uv_b, r2_rows, r2_cols, oct_a,
                           oct_b, band, N, M, idx, best, second, nullptr);
  return static_cast<int>(launch_scan<false>(p, static_cast<cudaStream_t>(stream)));
}

// The mutual match of A's rows against B's columns under the per-row radius
// (r2_rows, or none) and the octave gate: match [N] and best [N] are the
// results, idx and second [N] and col_key [M] scratch.
extern "C" int hamming_mutual_launch(const void* desc_a, const void* desc_b, const void* valid_a,
                                     const void* valid_b, const void* uv_a, const void* uv_b,
                                     const void* r2_rows, const void* oct_a, const void* oct_b,
                                     int band, int N, int M, int max_dist, float ratio,
                                     void* idx, void* best, void* second, void* col_key,
                                     void* match, void* stream) {
  if (N <= 0 || M < 0 || N >= (1 << ROW_BITS)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (M > 0) err = cudaMemsetAsync(col_key, 0xff, sizeof(unsigned) * (size_t)M, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args p = make_args(desc_a, desc_b, valid_a, valid_b, uv_a, uv_b, r2_rows, nullptr, oct_a,
                           oct_b, band, N, M, idx, best, second, col_key);
  err = launch_scan<true>(p, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  hamming_mutual_kernel<<<(N + 255) / 256, 256, 0, s>>>(
      static_cast<const int*>(idx), static_cast<const int*>(best), static_cast<const int*>(second),
      static_cast<const unsigned*>(col_key), N, max_dist, ratio, static_cast<int*>(match));
  return static_cast<int>(cudaGetLastError());
}
