// PNG scanline unfiltering (PNG specification, section 9), host code.
//
// The Sub, Average and Paeth filters predict each byte from the
// reconstructed byte `bpp` to its left, so a row is a sequential chain
// that numpy cannot vectorise; this loop is the decode's inner step,
// called through ctypes (which releases the GIL) by
// lgm_tpu_torch/io/png.py. Plain C interface, built with the host
// compiler by lgm_tpu_torch/ops/_build.py::build_host.

#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a);
  const int pb = std::abs(p - b);
  const int pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" {

// in: `height` rows of 1 + `rowbytes` bytes (filter type, filtered row);
// out: `height` rows of `rowbytes` reconstructed bytes; `bpp`: bytes per
// complete pixel, at least 1. Returns 0, or -1 when a row's filter type
// is not 0-4.
int png_unfilter(const uint8_t* in, uint8_t* out, int64_t height,
                 int64_t rowbytes, int bpp) {
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* src = in + y * (rowbytes + 1);
    const uint8_t type = *src++;
    uint8_t* dst = out + y * rowbytes;
    const uint8_t* up = y > 0 ? dst - rowbytes : nullptr;
    switch (type) {
      case 0:
        for (int64_t x = 0; x < rowbytes; ++x) dst[x] = src[x];
        break;
      case 1:
        for (int64_t x = 0; x < rowbytes; ++x)
          dst[x] = src[x] + (x >= bpp ? dst[x - bpp] : 0);
        break;
      case 2:
        for (int64_t x = 0; x < rowbytes; ++x)
          dst[x] = src[x] + (up ? up[x] : 0);
        break;
      case 3:
        for (int64_t x = 0; x < rowbytes; ++x) {
          const int a = x >= bpp ? dst[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          dst[x] = src[x] + static_cast<uint8_t>((a + b) >> 1);
        }
        break;
      case 4:
        for (int64_t x = 0; x < rowbytes; ++x) {
          const int a = x >= bpp ? dst[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          const int c = (up && x >= bpp) ? up[x - bpp] : 0;
          dst[x] = src[x] + paeth(a, b, c);
        }
        break;
      default:
        return -1;
    }
  }
  return 0;
}

}  // extern "C"
