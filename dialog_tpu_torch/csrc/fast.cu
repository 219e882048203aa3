// Kernel A: FAST-9 score + strict 3x3 NMS + border mask + two-tier rank, for
// every pyramid level of an image, or of a whole batch of images, in one launch.
//
// Replaces the Pallas kernel dialog_tpu/kernels/fast.py::fast_nms_rank
// (body _kernel). Per pixel of a pyramid level:
//
//   score = max threshold at which 9 contiguous pixels of the 16-pixel
//           radius-3 circle are all brighter, or all darker, than the center
//   rank  = 0                  unless a strict 3x3 local max inside the border
//                              with score > min_th
//         = score              if min_th < score <= th_fast
//         = score + 1000       if score > th_fast
//
// What bounds it on the H100: the levels are read once and the ranks written
// once (8 bytes per pixel: 2.3 us for the 8 levels of a 640x480 frame at the
// card's memory rate) against some 150 operations per pixel in the cheapest
// scheme known here (16 differences, 60 min/max per sign for the arcs, the
// score, the 3x3 maximum, the rank: 2.1 us at the f32 rate): bytes, by a
// little, and both lie near the cost of one launch.
// Hence one launch for all levels instead of one per level: the launcher
// fills a table of levels that is passed by value as a kernel parameter (no
// copy to the device, no sync) and a block finds its level by scanning the
// table's tile ranges.
// A batch of B images of one shape (the batched frontend: 8 mono images, or
// 8 stereo pairs stacked to 16) keeps that table and adds a batch axis: the
// levels arrive as contiguous [B, H_l, W_l] stacks, the grid's y dimension
// is the image, and a block offsets its level's pointers by the image index
// times the level's size. The table stays one entry per level (8, not 64 or
// 128), so it still travels by value and the scan for a block's level stays
// short; a table in device memory would cost a copy to the device per call.
//
// A block of 256 threads owns a 64 x 24 tile of scores, six per thread (the
// thread's column is tid & 63, so a warp reads 32 neighbouring floats of a
// shared-memory row: no bank conflicts, no divisions), computed from a
// 70 x 30 image tile (3 pixels of circle around it), and writes the tile's
// 62 x 22 interior, whose 3x3 neighbourhoods lie inside the tile. Every
// score is computed once per block and 1.13 times over blocks; the image is
// loaded 1.54 times. (Measured against four and eight rows per thread: six is
// the fastest on a 640x480 pyramid, eight a little faster on a 1241x376 one.)
// Per score: 16 differences to the centre, then the minimum of each of the 16
// arcs of 9 from the suffix and prefix minima of the circle's two halves (60
// operations, where doubling runs of 2, 4, 8, 9 takes 80 and trying every arc
// 144), the same for the maximum. The min/max operations, not the loads, set
// the kernel's time: it follows their count. Scores that no
// output can depend on are skipped: a pixel more than one step outside the
// border frame neither outputs a rank nor suppresses a pixel that does (a
// tile that lies wholly there only writes zeros). A compass-point test that
// skips the arcs of pixels which cannot score above min_th was tried and
// measured slower on rendered frames (a warp seldom rejects all 32 pixels,
// and the test itself costs): it is not here.
// The output of a level may be wider and taller than the level (the caller's
// cell-aligned buffer): the kernel writes the zeros of that pad too.
// Only subtractions and min/max are involved, so the result is bit-exact
// with the plain version. Out-of-image reads clamp to the edge (the reference
// pads the image in "edge" mode) and out-of-image scores are -inf in the NMS
// (the reference's reduce_window padding).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int NT = 256;              // threads per block
constexpr int SW = 64;               // score tile width
constexpr int RPT = 6;               // score rows per thread
constexpr int SH = (NT / SW) * RPT;  // score tile height
constexpr int RAD = 3;               // circle radius
constexpr int IW = SW + 2 * RAD;     // image tile
constexpr int IH = SH + 2 * RAD;
constexpr int OW = SW - 2;           // output tile: the score tile's interior
constexpr int OH = SH - 2;
constexpr int MAX_LEVELS = 32;

struct Level {
  const float* img;   // f32 [B, H, W]
  float* out;         // f32 [B, Ho, Wo], Ho >= H, Wo >= W: rank, zeros beyond the image
  int H, W, Ho, Wo;
  int tiles_x;        // output tiles per row of tiles
  int tile_end;       // one past this level's last block
};

struct LevelTable {
  Level lv[MAX_LEVELS];
  int n;
};

// The max over the 16 arcs of 9 of the arc's minimum, from the suffix and
// prefix minima of the circle's two halves: arc i = [i, i + 8] is the rest of
// i's half from i on, and the other half up to i + 8.
__device__ __forceinline__ float best_arc_min(const float (&d)[16]) {
  float suf[16], pre[16];
#pragma unroll
  for (int h = 0; h < 16; h += 8) {
    suf[h + 7] = d[h + 7];
    pre[h] = d[h];
#pragma unroll
    for (int i = 1; i < 8; ++i) {
      suf[h + 7 - i] = fminf(d[h + 7 - i], suf[h + 8 - i]);
      pre[h + i] = fminf(d[h + i], pre[h + i - 1]);
    }
  }
  float best = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < 16; ++i) best = fmaxf(best, fminf(suf[i], pre[(i + 8) & 15]));
  return best;
}

// the min over the 16 arcs of 9 of the arc's maximum, likewise
__device__ __forceinline__ float best_arc_max(const float (&d)[16]) {
  float suf[16], pre[16];
#pragma unroll
  for (int h = 0; h < 16; h += 8) {
    suf[h + 7] = d[h + 7];
    pre[h] = d[h];
#pragma unroll
    for (int i = 1; i < 8; ++i) {
      suf[h + 7 - i] = fmaxf(d[h + 7 - i], suf[h + 8 - i]);
      pre[h + i] = fmaxf(d[h + i], pre[h + i - 1]);
    }
  }
  float best = CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < 16; ++i) best = fminf(best, fmaxf(suf[i], pre[(i + 8) & 15]));
  return best;
}

__global__ void __launch_bounds__(NT)
fast_levels_kernel(const __grid_constant__ LevelTable tab, float min_th, float th_fast,
                   int border) {
  __shared__ float tile[IH][IW];
  __shared__ float score[SH][SW];

  int l = 0;
  while (l < tab.n - 1 && (int)blockIdx.x >= tab.lv[l].tile_end) ++l;
  const Level& L = tab.lv[l];
  const int t = blockIdx.x - (l ? tab.lv[l - 1].tile_end : 0);
  const int H = L.H, W = L.W;
  // this block's image of the batch (blockIdx.y): the levels are [B, H, W] stacks
  const float* __restrict__ img = L.img + (size_t)blockIdx.y * H * W;
  float* __restrict__ out = L.out + (size_t)blockIdx.y * L.Ho * L.Wo;
  const int x0 = (t % L.tiles_x) * OW;   // output tile origin
  const int y0 = (t / L.tiles_x) * OH;
  const int tid = threadIdx.x;
  const int sx = tid & (SW - 1);
  const int sy0 = tid / SW;

  // the pixels whose score an output can depend on: the border frame's
  // inside, one step wider
  const int nx0 = border - 1, nx1 = W - border, ny0 = border - 1, ny1 = H - border;
  const bool any_needed = x0 - 1 <= nx1 && x0 - 1 + SW > nx0 && y0 - 1 <= ny1 && y0 - 1 + SH > ny0 &&
                          nx0 <= nx1 && ny0 <= ny1;
  if (any_needed) {
    const int warp = tid >> 5, lane = tid & 31;
    for (int r = warp; r < IH; r += NT / 32) {
      const float* row = img + (size_t)min(max(y0 - 1 - RAD + r, 0), H - 1) * W;
      for (int c = lane; c < IW; c += 32) tile[r][c] = row[min(max(x0 - 1 - RAD + c, 0), W - 1)];
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int sy = sy0 + k * (NT / SW);
      const int x = x0 - 1 + sx, y = y0 - 1 + sy;
      float s = -CUDART_INF_F;
      if (x >= max(nx0, 0) && x <= min(nx1, W - 1) && y >= max(ny0, 0) && y <= min(ny1, H - 1)) {
        const float* p = &tile[sy + RAD][sx + RAD];
        const float c = p[0];
        // the circle in order: (dx, dy) = (3,0) (3,1) (2,2) (1,3) (0,3) (-1,3) (-2,2) (-3,1)
        // (-3,0) (-3,-1) (-2,-2) (-1,-3) (0,-3) (1,-3) (2,-2) (3,-1)
        float d[16];
        d[0] = p[3] - c;
        d[1] = p[IW + 3] - c;
        d[2] = p[2 * IW + 2] - c;
        d[3] = p[3 * IW + 1] - c;
        d[4] = p[3 * IW] - c;
        d[5] = p[3 * IW - 1] - c;
        d[6] = p[2 * IW - 2] - c;
        d[7] = p[IW - 3] - c;
        d[8] = p[-3] - c;
        d[9] = p[-IW - 3] - c;
        d[10] = p[-2 * IW - 2] - c;
        d[11] = p[-3 * IW - 1] - c;
        d[12] = p[-3 * IW] - c;
        d[13] = p[-3 * IW + 1] - c;
        d[14] = p[-2 * IW + 2] - c;
        d[15] = p[-IW + 3] - c;
        s = fmaxf(best_arc_min(d), -best_arc_max(d));
      }
      score[sy][sx] = s;
    }
    __syncthreads();
  }

  if (sx >= OW) return;
  const int x = x0 + sx;
  if (x >= L.Wo) return;
  const bool x_in = x >= border && x < W - border;
  // what a pixel of score 0 ranks as (0 for thresholds >= 0): the plain version's formula
  const float zero_rank = (0.0f > min_th && 0.0f > th_fast) ? 1000.0f : 0.0f;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int oy = sy0 + k * (NT / SW);
    const int y = y0 + oy;
    if (oy >= OH || y >= L.Ho) continue;
    float rank = (x < W && y < H) ? zero_rank : 0.0f;   // beyond the image: the pad
    if (any_needed && x_in && y >= border && y < H - border) {
      const float s = score[oy + 1][sx + 1];
      float mx = s;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) mx = fmaxf(mx, score[oy + dy][sx + dx]);
      const float sc = (s >= mx) ? s : 0.0f;
      rank = (sc > min_th) ? sc + ((sc > th_fast) ? 1000.0f : 0.0f) : 0.0f;
    }
    out[(size_t)y * L.Wo + x] = rank;
  }
}

}  // namespace

// imgs, outs: the n levels' device pointers (host arrays), each a contiguous stack of
// `batch` images [batch, H, W] and rank maps [batch, Ho, Wo]; dims: n x {H, W, Ho, Wo}.
// A level's [Ho, Wo] output takes ceil(Wo / OW) x ceil(Ho / OH) blocks, row-major, for
// each image of the batch (the grid's y dimension).
extern "C" int fast_levels_batch_launch(const void* const* imgs, void* const* outs, const int* dims, int n,
                                        int batch, float min_th, float th_fast, int border, void* stream) {
  if (n <= 0 || n > MAX_LEVELS || batch <= 0 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  LevelTable tab{};
  tab.n = n;
  int tile_end = 0;
  for (int l = 0; l < n; ++l) {
    Level& L = tab.lv[l];
    L.img = static_cast<const float*>(imgs[l]);
    L.out = static_cast<float*>(outs[l]);
    L.H = dims[4 * l];
    L.W = dims[4 * l + 1];
    L.Ho = dims[4 * l + 2];
    L.Wo = dims[4 * l + 3];
    if (L.H < 1 || L.W < 1 || L.Ho < L.H || L.Wo < L.W) return static_cast<int>(cudaErrorInvalidValue);
    L.tiles_x = (L.Wo + OW - 1) / OW;
    tile_end += L.tiles_x * ((L.Ho + OH - 1) / OH);
    L.tile_end = tile_end;
  }
  fast_levels_kernel<<<dim3(tile_end, batch), NT, 0, static_cast<cudaStream_t>(stream)>>>(tab, min_th, th_fast,
                                                                                         border);
  return static_cast<int>(cudaGetLastError());
}

// one image: the batch of one
extern "C" int fast_levels_launch(const void* const* imgs, void* const* outs, const int* dims, int n,
                                  float min_th, float th_fast, int border, void* stream) {
  return fast_levels_batch_launch(imgs, outs, dims, n, 1, min_th, th_fast, border, stream);
}
