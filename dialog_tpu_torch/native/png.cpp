// Undo the row filters of a PNG image stream (PNG specification, section 9).
//
// The inflated IDAT stream holds, per row, one filter-type byte and the
// row's filtered bytes. Sub, Up, Average and Paeth predict each byte from
// the byte one pixel to its left (bpp bytes back), the byte above, or both;
// Average and Paeth use the byte just decoded to the left, so a row decodes
// left to right, one byte after another. The plain numpy version beside this
// file (datasets/png.py: unfilter_plain) is the tests' reference.
//
// Built at first use by dialog_tpu_torch/native/__init__.py:
//   g++ -O3 -shared -fPIC -o build/dialog_tpu_torch/libnative_png_<hash>.so png.cpp

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

static inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  if (pb <= pc) return (uint8_t)b;
  return (uint8_t)c;
}

// src: rows x (1 + rowbytes) bytes; dst: rows x rowbytes. Returns 0, or
// 1 + the index of the first row whose filter type is not 0-4.
int png_unfilter(const uint8_t* src, int64_t rows, int64_t rowbytes, int32_t bpp, uint8_t* dst) {
  for (int64_t y = 0; y < rows; ++y) {
    const uint8_t* f = src + y * (rowbytes + 1);
    const uint8_t type = *f++;
    uint8_t* x = dst + y * rowbytes;
    const uint8_t* up = y > 0 ? x - rowbytes : nullptr;
    switch (type) {
      case 0:
        std::memcpy(x, f, (size_t)rowbytes);
        break;
      case 1:
        for (int64_t i = 0; i < rowbytes; ++i) x[i] = (uint8_t)(f[i] + (i >= bpp ? x[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < rowbytes; ++i) x[i] = (uint8_t)(f[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? x[i - bpp] : 0, b = up ? up[i] : 0;
          x[i] = (uint8_t)(f[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? x[i - bpp] : 0, b = up ? up[i] : 0, c = (up && i >= bpp) ? up[i - bpp] : 0;
          x[i] = (uint8_t)(f[i] + paeth(a, b, c));
        }
        break;
      default:
        return (int)(y + 1);
    }
  }
  return 0;
}

}  // extern "C"
