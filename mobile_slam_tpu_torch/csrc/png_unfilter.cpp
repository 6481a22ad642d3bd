// Row unfiltering of PNG image data for io/png.py: the five filter types
// of the PNG specification (section 9.2), byte by byte. raw holds h rows of
// one filter byte followed by stride bytes; out receives h * stride bytes.
// Each byte lane (bpp bytes per pixel) is unfiltered on its own, mod 256.

#include <cstddef>
#include <cstdint>
#include <cstdlib>

// Returns 0, or 1 + the index of the first row with an unknown filter byte.
extern "C" int msp_png_unfilter(const uint8_t* raw, uint8_t* out, int h,
                                int stride, int bpp) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* in = raw + size_t(y) * (stride + 1);
    const uint8_t kind = *in++;
    if (kind > 4) return y + 1;
    uint8_t* cur = out + size_t(y) * stride;
    const uint8_t* prev = y > 0 ? cur - stride : nullptr;
    for (int x = 0; x < stride; ++x) {
      const int a = x >= bpp ? cur[x - bpp] : 0;
      const int b = prev ? prev[x] : 0;
      const int c = prev && x >= bpp ? prev[x - bpp] : 0;
      int pred = 0;
      switch (kind) {
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: break;
      }
      cur[x] = uint8_t(in[x] + pred);
    }
  }
  return 0;
}
