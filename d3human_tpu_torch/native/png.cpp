// PNG scanline unfiltering for the port's image reader
// (utils/io.py:load_image). Python parses the chunks and inflates the
// image data with zlib; this undoes the per-row filters of a
// non-interlaced 8-bit image. The Sub, Average and Paeth filters read the
// byte one pixel to the left in the row being rebuilt, so a row cannot be
// vectorised across its bytes: it is a plain loop here.
//
// C ABI (ctypes), no dependencies.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" {

// raw: height rows of (1 filter byte + stride bytes), as inflated.
// out: height * stride bytes. bpp: bytes per pixel (1..4).
// Returns 0, or 1 + the first row whose filter type is not 0..4.
int64_t png_unfilter(const uint8_t* raw, uint8_t* out, int64_t height,
                     int64_t stride, int32_t bpp) {
  std::vector<uint8_t> zeros(static_cast<size_t>(stride), 0);
  const uint8_t* prev = zeros.data();
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* src = raw + y * (stride + 1);
    const uint8_t ft = *src++;
    uint8_t* cur = out + y * stride;
    switch (ft) {
      case 0:
        std::memcpy(cur, src, static_cast<size_t>(stride));
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(src[i] +
                                        (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(src[i] + prev[i]);
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          cur[i] = static_cast<uint8_t>(src[i] + ((a + prev[i]) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int c = i >= bpp ? prev[i - bpp] : 0;
          cur[i] = static_cast<uint8_t>(src[i] + paeth(a, prev[i], c));
        }
        break;
      default:
        return y + 1;
    }
    prev = cur;
  }
  return 0;
}

}  // extern "C"
