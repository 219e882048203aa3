// Kernel A: FAST-9 score + strict 3x3 NMS + border mask + two-tier rank.
//
// Replaces the Pallas kernel dialog_tpu/kernels/fast.py::fast_nms_rank
// (body _kernel). Per pixel of one pyramid level:
//
//   score = max threshold at which 9 contiguous pixels of the 16-pixel
//           radius-3 circle are all brighter, or all darker, than the center
//   rank  = 0                  unless a strict 3x3 local max inside the border
//                              with score > min_th
//         = score              if min_th < score <= th_fast
//         = score + 1000       if score > th_fast
//
// What bounds it on the H100: the image is read once and the rank written
// once (8 bytes per pixel, ~2.5 MB for a 640x480 frame's 8 levels), so the
// kernel is launch- and latency-bound at these sizes, not compute-bound.
// Design: one 32x8-pixel tile per block with a 4-pixel halo in shared memory
// (3 for the circle, 1 for the NMS). Scores for the tile plus a one-pixel
// ring go to shared memory, then each thread applies the NMS to its pixel.
// The TPU-only parts are gone: no cyclic roll, no strip sizing, no padding
// to 128 lanes. Only subtractions and min/max are involved, so the result
// is bit-exact with the plain version. Out-of-image reads clamp to the edge
// (the reference pads the image in "edge" mode) and out-of-image scores are
// -inf in the NMS (the reference's reduce_window padding).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TW = 32;
constexpr int TH = 8;
constexpr int HALO = 4;
constexpr int IW = TW + 2 * HALO;   // image tile width
constexpr int IH = TH + 2 * HALO;
constexpr int SW = TW + 2;          // score tile width (one-pixel NMS ring)
constexpr int SH = TH + 2;

__constant__ int kDx[16] = {3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1, 0, 1, 2, 3};
__constant__ int kDy[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

__global__ void fast_nms_rank_kernel(const float* __restrict__ img,
                                     float* __restrict__ out, int H, int W,
                                     float min_th, float th_fast, int border) {
  __shared__ float tile[IH][IW];
  __shared__ float score[SH][SW];
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * TW + threadIdx.x;
  const int nthreads = TW * TH;

  for (int i = tid; i < IH * IW; i += nthreads) {
    int ty = i / IW, tx = i % IW;
    int y = min(max(y0 - HALO + ty, 0), H - 1);
    int x = min(max(x0 - HALO + tx, 0), W - 1);
    tile[ty][tx] = img[y * W + x];
  }
  __syncthreads();

  for (int i = tid; i < SH * SW; i += nthreads) {
    int sy = i / SW, sx = i % SW;
    int y = y0 - 1 + sy, x = x0 - 1 + sx;
    float s = -CUDART_INF_F;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      int cy = sy + HALO - 1, cx = sx + HALO - 1;
      float c = tile[cy][cx];
      float d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) d[k] = tile[cy + kDy[k]][cx + kDx[k]] - c;
      float bright = -CUDART_INF_F;   // max over arcs of min(d): brighter arc
      float dark = CUDART_INF_F;      // min over arcs of max(d): darker arc
#pragma unroll
      for (int st = 0; st < 16; ++st) {
        float mn = d[st], mx = d[st];
#pragma unroll
        for (int j = 1; j < 9; ++j) {
          mn = fminf(mn, d[(st + j) & 15]);
          mx = fmaxf(mx, d[(st + j) & 15]);
        }
        bright = fmaxf(bright, mn);
        dark = fminf(dark, mx);
      }
      s = fmaxf(bright, -dark);
    }
    score[sy][sx] = s;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const float s = score[threadIdx.y + 1][threadIdx.x + 1];
  float mx = s;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) mx = fmaxf(mx, score[threadIdx.y + dy][threadIdx.x + dx]);
  float sc = (s >= mx) ? s : 0.0f;
  bool inb = (y >= border) && (y < H - border) && (x >= border) && (x < W - border);
  if (!inb) sc = 0.0f;
  float rank = 0.0f;
  if (sc > min_th) rank = sc + ((sc > th_fast) ? 1000.0f : 0.0f);
  out[y * W + x] = rank;
}

}  // namespace

extern "C" int fast_nms_rank_launch(const float* img, float* out, int H, int W,
                                    float min_th, float th_fast, int border,
                                    void* stream) {
  dim3 block(TW, TH);
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  fast_nms_rank_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, out, H, W, min_th, th_fast, border);
  return static_cast<int>(cudaGetLastError());
}
